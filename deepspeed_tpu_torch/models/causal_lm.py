"""Unified causal-LM family with KV-cache serving, in PyTorch.

Counterpart of ``deepspeed_tpu/models/causal_lm.py``: one configurable
transformer covers the families (learned/rotary/ALiBi positions, parallel
residual, GQA, gated MLP, pre-LN with LayerNorm or RMSNorm), and per-family
constructors pin the knobs. Prefill attention goes through the flash kernel
(``ops/attention/flash.py``); decode attention goes through the decode kernel
(``ops/attention/decode.py``) against a head-major ``(b, h_kv, T, d)`` cache,
or through the paged decode kernel (``ops/paged_attention.py``) against a
global pool of KV pages and a page table, except ALiBi (BLOOM) decode, which
is plain tensor code as in the JAX package. Suffix prefill (``prefix_fill``,
the prefix-cache hit path) attends in plain tensor code, as JAX does in XLA.

Parameters follow the JAX tree's names. A projection's ``weight`` is
``(out, in)``, the flax ``kernel`` transposed (``models/convert.py``). Norms run
in f32; 1-D parameters stay f32 when the engine casts the rest to the serve
dtype, and are cast where they are used.

The KV caches are updated in place: prefill writes rows ``[0, t)``, a decode
step writes one row per sequence at ``cache_len`` (clamped to ``T - 1``, as
``dynamic_update_slice`` clamps; paged: at the page-mapped row), a suffix
prefill writes rows ``[cache_len, cache_len + t)`` below ``T``, so no second
cache is ever allocated.

A served projection may be a :class:`QuantDense` instead of a :class:`Dense`:
the engine swaps it in at the ``QUANT_NAMES`` sites when weight quantization
is on (``inference/engine.py``), and its product runs in the dequant-GEMM
kernel (``ops/quantizer/fused_matmul.py``).

With ``num_experts > 0`` every ``moe_layer_interval``-th layer's FFN is a
gated mixture of experts (:meth:`CausalLMLayer._moe_mlp`, JAX's serving MoE):
a decode step runs only the selected experts, through the selected-expert FFN
kernel (``ops/moe/decode_ffn.py``); prefill routes through JAX's chunked
one-hot dispatch. Tensor parallelism and expert parallelism are not ported
(ROADMAP.md queue 1 item 11).

:func:`causal_lm_model` trains every family (JAX ``causal_lm.py:880-909``):
the loss over shifted labels through the full-sequence forward with no
caches (``train=True``), which writes nothing in place, attends through the
flash kernels under autograd (ALiBi slopes inside them; GQA repeats the kv
heads first) and routes every MoE layer through the dispatch branch with
eval-mode gating, as JAX's MoE layers of a ``CausalLMConfig`` train: the
decode fast path's kernel has no backward and is never taken there.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.func import functional_call

from ..accelerator import resolve_device
from ..moe.sharded_moe import TopKGate, topk_select
from ..ops.attention.decode import decode_attention
from ..ops.attention.flash import flash_attention, kernel_width
from ..ops.moe import (ACTIVATIONS, moe_decode_ffn, moe_decode_ffn_quant,
                       moe_decode_ffn_xla)
from ..ops.paged_attention import gather_kv_dense, paged_attention, paged_cache_update
from ..ops.quantizer import (dequantize_node, is_quant_node, make_quant_node, node_bits,
                             node_qs, quant_dense_apply)
from .base import Model, Params


@dataclasses.dataclass
class CausalLMConfig:
    vocab_size: int = 50257
    max_seq_len: int = 2048
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None          # GQA; None → MHA
    d_ff: Optional[int] = None               # None → 4*n_embd
    pos_emb: str = "learned"                 # learned | rotary | alibi | none
    rotary_pct: float = 1.0                  # NeoX partial rotary
    rotary_base: float = 10000.0
    parallel_residual: bool = False          # NeoX/GPT-J
    gated_mlp: bool = False                  # LLaMA SwiGLU
    activation: str = "gelu"                 # gelu | relu | silu
    layernorm: str = "layernorm"             # layernorm | rmsnorm
    ln_eps: float = 1e-5
    embed_layernorm: bool = False            # BLOOM
    tie_word_embeddings: bool = True
    qkv_bias: bool = True
    mlp_bias: bool = True
    lm_head_bias: bool = False               # GPT-J ties nothing and biases the head
    dtype: torch.dtype = torch.bfloat16
    init_std: float = 0.02
    name: str = "causal-lm"
    # MoE serving: every ``moe_layer_interval``-th layer's FFN is a gated expert
    # mixture. 0 experts = dense.
    num_experts: int = 0
    moe_layer_interval: int = 2
    moe_top_k: int = 1
    # decode (t == 1) runs only the selected experts instead of the all-expert
    # dispatch; False = always dispatch (parity testing)
    moe_decode_fastpath: bool = True
    # the JAX spellings, kept for config compatibility: "pallas" = the
    # selected-expert FFN kernel (K7); "xla" = w[idx] gather + batched products
    moe_decode_impl: str = "pallas"

    VALID_MOE_DECODE_IMPLS = ("pallas", "xla")

    def __post_init__(self):
        # case-sensitive on purpose: 'XLA'/'Pallas'/'triton' must not silently
        # select the kernel through a failed == "xla" comparison
        check_moe_decode_impl(self.moe_decode_impl)

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and (i + 1) % self.moe_layer_interval == 0

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or 4 * self.n_embd

    def num_params(self) -> int:
        d, L, v = self.n_embd, self.n_layer, self.vocab_size
        f = self.ffn_dim
        mlp = d * f * (3 if self.gated_mlp else 2)
        attn = d * d + 2 * d * self.kv_heads * self.head_dim + d * d
        n_moe = sum(1 for i in range(L) if self.is_moe_layer(i))
        moe_extra = n_moe * (self.num_experts - 1) * 2 * d * f
        return (v * d + L * (attn + mlp) + moe_extra +
                (0 if self.tie_word_embeddings else v * d))


def check_moe_decode_impl(impl) -> None:
    """Raise ``ValueError`` unless ``impl`` is one of the decode impls."""
    if impl not in CausalLMConfig.VALID_MOE_DECODE_IMPLS:
        raise ValueError(f"moe_decode_impl={impl!r} is not one of "
                         f"{CausalLMConfig.VALID_MOE_DECODE_IMPLS}")


# ---------------------------------------------------------------- family constructors
def gpt2_cfg(**kw) -> CausalLMConfig:
    return CausalLMConfig(pos_emb="learned", activation="gelu", name="gpt2", **kw)


def bloom_cfg(**kw) -> CausalLMConfig:
    """BLOOM: ALiBi positions, embedding layernorm, tied head."""
    kw.setdefault("pos_emb", "alibi")
    kw.setdefault("embed_layernorm", True)
    kw.setdefault("name", "bloom")
    return CausalLMConfig(**kw)


def opt_cfg(**kw) -> CausalLMConfig:
    kw.setdefault("pos_emb", "learned")
    kw.setdefault("activation", "relu")
    kw.setdefault("name", "opt")
    return CausalLMConfig(**kw)


def gptneox_cfg(**kw) -> CausalLMConfig:
    """GPT-NeoX: partial rotary, parallel residual."""
    kw.setdefault("pos_emb", "rotary")
    kw.setdefault("rotary_pct", 0.25)
    kw.setdefault("parallel_residual", True)
    kw.setdefault("tie_word_embeddings", False)
    kw.setdefault("name", "gpt-neox")
    return CausalLMConfig(**kw)


def gptj_cfg(**kw) -> CausalLMConfig:
    kw.setdefault("pos_emb", "rotary")
    kw.setdefault("rotary_pct", 0.25)
    kw.setdefault("parallel_residual", True)
    kw.setdefault("name", "gptj")
    return CausalLMConfig(**kw)


def llama_cfg(**kw) -> CausalLMConfig:
    kw.setdefault("pos_emb", "rotary")
    kw.setdefault("gated_mlp", True)
    kw.setdefault("activation", "silu")
    kw.setdefault("layernorm", "rmsnorm")
    kw.setdefault("qkv_bias", False)
    kw.setdefault("mlp_bias", False)
    kw.setdefault("tie_word_embeddings", False)
    kw.setdefault("ln_eps", 1e-6)
    kw.setdefault("name", "llama")
    return CausalLMConfig(**kw)


FAMILIES = {
    "gpt2": gpt2_cfg, "bloom": bloom_cfg, "opt": opt_cfg,
    "gpt_neox": gptneox_cfg, "gptj": gptj_cfg, "llama": llama_cfg,
}


# ----------------------------------------------------------------------- positional
def alibi_slopes(n_head: int) -> np.ndarray:
    """BLOOM ALiBi slope schedule (geometric in powers of 2), f32."""
    closest = 2 ** int(np.floor(np.log2(n_head)))
    base = 2.0 ** (-(2.0 ** -(np.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1)
    if closest < n_head:
        extra_base = 2.0 ** (-(2.0 ** -(np.log2(2 * closest) - 3)))
        extra = extra_base ** np.arange(1, 2 * (n_head - closest) + 1, 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, base: float,
                 pct: float) -> torch.Tensor:
    """x ``(b, t, h, d)``, positions ``(b, t)``: rotate the first
    ``int(d * pct)`` (even) channels, in f32."""
    d = x.shape[-1]
    rot = int(d * pct) // 2 * 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv_freq = 1.0 / (base ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    inv_freq = torch.from_numpy(np.asarray(inv_freq, np.float32)).to(x.device)
    freqs = positions[..., None].float() * inv_freq[None, None]        # (b, t, rot/2)
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]             # (b, t, 1, rot)
    cos, sin = emb.cos(), emb.sin()
    x_rot = x_rot.float()
    out = x_rot * cos + rotate_half(x_rot) * sin
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------- modules
class LayerNorm(nn.Module):
    """f32 LayerNorm (``weight`` = flax ``scale``)."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


class RMSNorm(nn.Module):
    """f32 RMSNorm (``weight`` = flax ``scale``)."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()


def _norm(cfg: CausalLMConfig, device) -> nn.Module:
    cls = RMSNorm if cfg.layernorm == "rmsnorm" else LayerNorm
    return cls(cfg.n_embd, cfg.ln_eps, device)


class Dense(nn.Module):
    """``x @ weight.T + bias`` computed in ``dtype``. ``weight`` is ``(out, in)``;
    ``bias`` stays f32 and is cast at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


#: the projections weight quantization may replace (the JAX engine's
#: ``_QUANT_NAMES``); embeddings, norms and the head stay fp
QUANT_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "fc_in", "fc_out", "gate_proj",
               "up_proj")


class QuantNode(nn.Module):
    """A quant node held as buffers ``int8_q`` and ``int8_scale`` (or ``int4_q``
    and ``int4_scale``): the int8 payload in the JAX node's ``(..., in, out)``
    layout (``(..., in/2, out)`` packed for int4) and the f32 scales ``(...,
    in/g, out)``, so a state dict names the bits in its keys. An expert stack
    quantized by the engine is one (``ExpertWeights.quantize``)."""

    def __init__(self, node):
        super().__init__()
        self.bits = node_bits(node)
        q, s = node_qs(node)
        self.register_buffer(f"int{self.bits}_q", q.contiguous())
        self.register_buffer(f"int{self.bits}_scale", s.float().contiguous())

    def node(self) -> dict:
        return make_quant_node(getattr(self, f"int{self.bits}_q"),
                               getattr(self, f"int{self.bits}_scale"), self.bits)


class QuantDense(QuantNode):
    """A projection over a quant node, the counterpart of the JAX
    ``QuantDense``: ``x @ dequant(payload, scales) + bias`` in ``dtype``, the
    payload ``(in, out)``. ``bias`` stays f32, as in :class:`Dense`."""

    def __init__(self, node, bias: Optional[nn.Parameter], dtype):
        super().__init__(node)
        self.dtype = dtype
        self.bias = bias

    def forward(self, x):
        return quant_dense_apply(x, self.node(), self.bias, self.dtype)


class ExpertWeights(nn.Module):
    """The stacked expert FFNs of an MoE layer, in the JAX tree's layout
    (``moe_experts/{w1,b1,w2,b2}``): ``w1 (e, d, f)``, ``b1 (e, f)``, ``w2
    (e, f, d)``, ``b2 (e, d)``, so that conversion and quantization are byte
    for byte the JAX package's. The engine may replace ``w1``/``w2`` with a
    :class:`QuantNode` (:meth:`quantize`)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int, device):
        super().__init__()
        e, d, f = num_experts, d_model, d_ff
        self.w1 = nn.Parameter(torch.empty(e, d, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, d, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, d, device=device))

    def quantize(self, name: str, node) -> None:
        """Serve ``w1`` or ``w2`` from the quant node ``node``."""
        delattr(self, name)
        setattr(self, name, QuantNode(node))

    def weights(self):
        """``(w1, b1, w2, b2)``; a quantized stack comes as its quant node."""
        def get(name):
            w = getattr(self, name)
            return w.node() if isinstance(w, QuantNode) else w

        return get("w1"), self.b1, get("w2"), self.b2


class CausalLMLayer(nn.Module):
    # prefill tokens are routed in chunks of this size: the one-hot
    # dispatch/combine tensors are (C, e, C) per chunk, linear in the token
    # count where one whole-sequence no-drop dispatch would be quadratic
    MOE_CHUNK = 256

    def __init__(self, cfg: CausalLMConfig, device, is_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_moe = is_moe
        d, hd, dt = cfg.n_embd, cfg.head_dim, cfg.dtype
        self.ln_attn = _norm(cfg, device)
        self.q_proj = Dense(d, cfg.n_head * hd, cfg.qkv_bias, dt, device)
        self.k_proj = Dense(d, cfg.kv_heads * hd, cfg.qkv_bias, dt, device)
        self.v_proj = Dense(d, cfg.kv_heads * hd, cfg.qkv_bias, dt, device)
        # o_proj's bias follows mlp_bias, as in the JAX layer
        self.o_proj = Dense(d, d, cfg.mlp_bias, dt, device)
        self.ln_mlp = _norm(cfg, device)
        if is_moe:
            # the experts are plain (ungated) FFNs with biases in every family
            self.moe_gate = nn.Parameter(torch.empty(d, cfg.num_experts, device=device))
            self.moe_experts = ExpertWeights(cfg.num_experts, d, cfg.ffn_dim, device)
        else:
            if cfg.gated_mlp:
                self.gate_proj = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
                self.up_proj = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
            else:
                self.fc_in = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
            self.fc_out = Dense(cfg.ffn_dim, d, cfg.mlp_bias, dt, device)
        self.act = ACTIVATIONS[cfg.activation]
        slopes = (torch.from_numpy(alibi_slopes(cfg.n_head)).to(device)
                  if cfg.pos_emb == "alibi" else None)
        self.register_buffer("alibi", slopes, persistent=False)

    def _mlp(self, h):
        if self.cfg.gated_mlp:
            h = self.act(self.gate_proj(h)) * self.up_proj(h)
        else:
            h = self.act(self.fc_in(h))
        return self.fc_out(h)

    def _moe_mlp(self, h, train: bool = False):
        """Gated expert-mixture FFN for serving, JAX's three branches in JAX's
        order. Eval-mode gating: deterministic, no token drops.

        - Quantized experts at a decode step (t == 1, ``moe_decode_fastpath``,
          more experts than ``moe_top_k``): gather the selected experts'
          int8/int4 payloads and dequantize only those slices
          (``moe_decode_ffn_quant``, plain tensor code; K7 does not run).
        - fp decode step, same conditions: the selected-expert FFN, K7
          (``moe_decode_impl="pallas"``) or the gather path (``"xla"``). The
          routing indices stay on the device: no host synchronisation.
        - Otherwise (prefill, suffix prefill, fast path off): tokens in chunks
          of ``MOE_CHUNK`` are dispatched to every expert's ``cap`` slots by
          one-hot tensors (capacity = chunk, so nothing drops), every expert
          runs on its slots, and the combine weights sum the outputs back in
          f32; quantized stacks are dequantized first. A training forward
          (``train``) always takes this branch."""
        cfg = self.cfg
        b, t, d = h.shape
        s = b * t
        x = h.reshape(s, d)
        wg = self.moe_gate
        w1, b1, w2, b2 = self.moe_experts.weights()
        cdtype = cfg.dtype
        k = cfg.moe_top_k
        quant = is_quant_node(w1) or is_quant_node(w2)
        fast = not train and t == 1 and cfg.moe_decode_fastpath and cfg.num_experts > k
        if fast:
            # dispatch-time re-validation: a config changed after construction
            # must not fall through to the kernel
            check_moe_decode_impl(cfg.moe_decode_impl)
            logits = x.float() @ wg.float()                              # (s, e)
            idx, gw = topk_select(logits, k)                             # (s, k) x2
            xk = x.to(cdtype)[:, None, :].expand(s, k, d).reshape(s * k, d)
            if quant:
                y = moe_decode_ffn_quant(xk, idx.reshape(-1), w1, b1, w2, b2,
                                         cfg.activation)
            else:
                ffn = moe_decode_ffn_xla if cfg.moe_decode_impl == "xla" else moe_decode_ffn
                y = ffn(xk, idx.reshape(-1), w1.to(cdtype), b1.to(cdtype), w2.to(cdtype),
                        b2.to(cdtype), cfg.activation)
            out = torch.einsum("bk,bkm->bm", gw, y.reshape(s, k, d))
            return out.reshape(b, t, d).to(h.dtype)
        if quant:
            w1 = dequantize_node(w1) if is_quant_node(w1) else w1
            w2 = dequantize_node(w2) if is_quant_node(w2) else w2

        gate = TopKGate(k=k, drop_tokens=False, use_rts=False, top2_2nd_expert_sampling=False)
        e = cfg.num_experts
        chunk = min(s, self.MOE_CHUNK)
        xc = F.pad(x, (0, 0, 0, (-s) % chunk)).reshape(-1, chunk, d)      # (n, C, m)
        n = xc.shape[0]
        gated = [gate(wg, xc[i], train=False) for i in range(n)]
        combine = torch.stack([g[1] for g in gated])                      # (n, C, e, cap)
        dispatch = torch.stack([g[2] for g in gated])
        cap = combine.shape[-1]          # chunk for top-1, 2 * chunk for top-2 (no drops)
        expert_in = torch.einsum("nsec,nsm->encm", dispatch.float(),
                                 xc.float()).to(cdtype).reshape(e, n * cap, d)
        hh = torch.einsum("ecm,emf->ecf", expert_in, w1.to(cdtype)) + \
            b1[:, None, :].to(cdtype)
        hh = self.act(hh)
        expert_out = torch.einsum("ecf,efm->ecm", hh, w2.to(cdtype)) + \
            b2[:, None, :].to(cdtype)
        expert_out = expert_out.reshape(e, n, cap, d)
        out = torch.einsum("nsec,encm->nsm", combine.float(), expert_out.float())
        return out.reshape(-1, d)[:s].reshape(b, t, d).to(h.dtype)

    def forward(self, x, positions, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[torch.Tensor] = None, prefix_fill: bool = False,
                page_table: Optional[torch.Tensor] = None, kv_cap: Optional[int] = None,
                train: bool = False):
        """x ``(b, t, d)``. With ``cache`` and t == 1 (decode): write this step's
        K/V at row ``cache_len`` and attend over rows ``[0, cache_len]``; with
        ``page_table`` ``(b, max_pages)`` the cache holds global pages
        ``(P, h_kv, page, d)`` and row r of sequence i lives in page
        ``page_table[i, r // page]`` (``kv_cap``: the slot capacity of a dense
        view, ``max_pages * page`` by default). With ``cache`` and
        ``prefix_fill`` (suffix prefill): the cache holds a prompt prefix in
        rows ``[0, cache_len)``; write the t suffix rows at ``cache_len + i``
        and attend each over every row at or before its position. With
        ``cache`` otherwise (prefill): attend over the prompt and write its K/V
        into rows ``[0, t)``. ``train``: a training forward (no cache; see
        :meth:`_moe_mlp`)."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd, hk = cfg.head_dim, cfg.kv_heads
        h_in = self.ln_attn(x).to(cfg.dtype)
        q = self.q_proj(h_in).view(b, t, cfg.n_head, hd)
        k = self.k_proj(h_in).view(b, t, hk, hd)
        v = self.v_proj(h_in).view(b, t, hk, hd)
        if cfg.pos_emb == "rotary":
            q = apply_rotary(q, positions, cfg.rotary_base, cfg.rotary_pct)
            k = apply_rotary(k, positions, cfg.rotary_base, cfg.rotary_pct)

        if cache is not None and t == 1 and page_table is not None:
            paged_cache_update(cache["k"], cache["v"], k.transpose(1, 2), v.transpose(1, 2),
                               page_table, cache_len)
            lens = cache_len + 1
            q1 = q[:, 0].contiguous()
            cap = kv_cap or page_table.shape[1] * cache["k"].shape[2]
            if self.alibi is not None:
                kd, vd = gather_kv_dense(cache["k"], cache["v"], page_table, cap)
                o = decode_attention_alibi_plain(q1, kd, vd, lens, self.alibi)
            else:
                o = paged_attention(q1, cache["k"], cache["v"], page_table, lens, cap)
            o = o[:, None]
        elif cache is not None and t == 1:
            cache_update(cache["k"], k.transpose(1, 2), cache_len)
            cache_update(cache["v"], v.transpose(1, 2), cache_len)
            lens = cache_len + 1
            q1 = q[:, 0].contiguous()
            if self.alibi is not None:
                o = decode_attention_alibi_plain(q1, cache["k"], cache["v"], lens, self.alibi)
            else:
                o = decode_attention(q1, cache["k"], cache["v"], lens)
            o = o[:, None]
        elif cache is not None and prefix_fill:
            write_rows(cache["k"], k.transpose(1, 2), cache_len)
            write_rows(cache["v"], v.transpose(1, 2), cache_len)
            o = prefix_attention(q, cache["k"], cache["v"], cache_len, self.alibi)
        else:
            o = bias_attention(q, k, v, self.alibi)
            if cache is not None:
                cache["k"][:, :, :t] = k.transpose(1, 2)
                cache["v"][:, :, :t] = v.transpose(1, 2)
        attn_out = self.o_proj(o.reshape(b, t, cfg.n_embd))

        def mlp(h):
            return self._moe_mlp(h, train) if self.is_moe else self._mlp(h)

        if cfg.parallel_residual:
            return x + attn_out + mlp(self.ln_mlp(x).to(cfg.dtype))
        x = x + attn_out
        return x + mlp(self.ln_mlp(x).to(cfg.dtype))


def bias_attention(q, k, v, slopes: Optional[torch.Tensor]):
    """Full-sequence causal attention through the flash kernel, with the ALiBi
    bias inside the kernel when ``slopes`` is given, at every length. GQA
    prefill repeats each kv head over its group of query heads first."""
    if k.shape[2] != q.shape[2]:
        g = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return flash_attention(q, k, v, causal=True, alibi_slopes=slopes)


def cache_update(cache: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor) -> None:
    """In place: ``cache (b, hk, T, d)`` row ``cache_len[i]`` of sequence ``i``
    ← ``new (b, hk, 1, d)``. The row is clamped to ``[0, T - 1]``, as
    ``dynamic_update_slice`` clamps its start, so nothing is written out of
    bounds."""
    b, _, cap, _ = cache.shape
    rows = cache_len.long().clamp(0, cap - 1)
    cache[torch.arange(b, device=cache.device), :, rows] = new[:, :, 0].to(cache.dtype)


def write_rows(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """In place: ``cache (b, hk, T, d)`` rows ``[start[i], start[i] + t)`` of
    sequence ``i`` ← ``new (b, hk, t, d)``; rows at or past ``T`` are dropped.

    Out-of-range indices: JAX's scatter drops rows past ``T``, where a PyTorch
    index write would assert or write out of bounds, and clamping them would
    make several rows race for row ``T - 1``. So every cache row is written
    exactly once, from its own suffix row where it has one and from itself
    elsewhere: a whole-cache pass, paid once per prefill."""
    b, hk, cap, d = cache.shape
    t = new.shape[2]
    rel = torch.arange(cap, device=cache.device)[None, :] - start.long()[:, None]   # (b, T)
    inside = (rel >= 0) & (rel < t)
    src = new.to(cache.dtype).gather(2, rel.clamp(0, t - 1)[:, None, :, None].expand(b, hk, cap, d))
    cache.copy_(torch.where(inside[:, None, :, None], src, cache))


def prefix_attention(q, k_cache, v_cache, offset, slopes=None):
    """Suffix-prefill attention in f32 plain tensor code, as JAX's
    ``_prefix_attention_xla``: queries at positions ``offset + i`` over every
    cache row (restored prefix and just-written suffix), masked ``key_pos <=
    query_pos``, with the ALiBi bias when ``slopes`` is given. q ``(b, t, h,
    d)``; caches ``(b, hk, T, d)``; offset ``(b,)``."""
    b, t, h, d = q.shape
    hk, cap = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    q5 = q.reshape(b, t, hk, g, d).float()
    s = torch.einsum("btkgd,bkTd->bkgtT", q5, k_cache.float()) / float(np.sqrt(d))
    q_pos = offset.long()[:, None] + torch.arange(t, device=q.device)[None]      # (b, t)
    k_pos = torch.arange(cap, device=q.device)
    if slopes is not None:
        rel = (k_pos[None, None, :] - q_pos[:, :, None]).float()
        s = s + slopes.float().reshape(1, hk, g, 1, 1) * rel[:, None, None]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]                              # (b, t, T)
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgtT,bkTd->btkgd", p, v_cache.float())
    return o.reshape(b, t, h, d).to(q.dtype)


def decode_attention_alibi_plain(q, k_cache, v_cache, cache_len, slopes):
    """Decode attention with the ALiBi bias (BLOOM decode), in f32 plain tensor
    code as in the JAX package."""
    b, h, d = q.shape
    hk, cap = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    q4 = q.reshape(b, hk, g, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", q4, k_cache.float()) / float(np.sqrt(d))
    pos = torch.arange(cap, device=q.device)[None, None, None, :]
    cur = (cache_len[:, None, None, None] - 1).float()
    s = s + slopes.float().reshape(1, hk, g, 1) * (pos - cur)
    s = s.masked_fill(pos >= cache_len[:, None, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


class CausalLM(nn.Module):
    def __init__(self, cfg: CausalLMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd, device=device))
        if cfg.pos_emb == "learned":
            self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.n_embd, device=device))
        if cfg.embed_layernorm:
            self.ln_embed = _norm(cfg, device)
        self.layers = nn.ModuleList(CausalLMLayer(cfg, device, cfg.is_moe_layer(i))
                                    for i in range(cfg.n_layer))
        self.ln_f = _norm(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.n_embd, cfg.vocab_size, cfg.lm_head_bias,
                                 torch.float32, device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random weights with the JAX model's initialisers: normal with
        ``init_std`` for embeddings and projections, ``init_std / sqrt(2 *
        n_layer)`` for ``o_proj``/``fc_out``, zero biases, unit norm scales;
        MoE layers: gate and both expert stacks normal with ``init_std``, zero
        expert biases. One ``torch.Generator`` on the parameters' device,
        seeded with ``seed``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.wte.device).manual_seed(seed)
        proj_std = cfg.init_std / (2 * cfg.n_layer) ** 0.5
        for name, mod in self.named_modules():
            if isinstance(mod, (LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
                if isinstance(mod, LayerNorm):
                    mod.bias.zero_()
            elif isinstance(mod, Dense):
                std = proj_std if name.endswith(("o_proj", "fc_out")) else cfg.init_std
                mod.weight.normal_(0.0, std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, CausalLMLayer) and mod.is_moe:
                mod.moe_gate.normal_(0.0, cfg.init_std, generator=gen)
            elif isinstance(mod, ExpertWeights):
                for w in (mod.w1, mod.w2):
                    w.normal_(0.0, cfg.init_std, generator=gen)
                mod.b1.zero_()
                mod.b2.zero_()
        self.wte.normal_(0.0, cfg.init_std, generator=gen)
        if cfg.pos_emb == "learned":
            self.wpe.normal_(0.0, cfg.init_std, generator=gen)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Dict[str, torch.Tensor]]] = None,
                cache_lens: Optional[torch.Tensor] = None,
                logits_positions: Optional[torch.Tensor] = None,
                prefix_fill: bool = False, page_table: Optional[torch.Tensor] = None,
                kv_cap: Optional[int] = None, train: bool = False):
        """``input_ids (b, t)`` → f32 logits ``(b, t, V)``, or ``(b, 1, V)`` read
        only at ``logits_positions (b,)``. With ``caches`` (from
        :func:`init_cache`, or a paged pool's pages with ``page_table``; updated
        in place) returns ``(logits, caches)``. ``prefix_fill``: suffix prefill
        at offset ``cache_lens``; the caller passes ``positions = cache_lens +
        arange(t)``. ``train``: a training forward, with no caches. See
        :meth:`CausalLMLayer.forward`."""
        if train and caches is not None:
            raise ValueError("a training forward takes no KV caches")
        cfg = self.cfg
        b, t = input_ids.shape
        if positions is None:
            positions = torch.arange(t, device=input_ids.device)[None].expand(b, t)
        x = F.embedding(input_ids.long(), self.wte).to(cfg.dtype)
        if cfg.pos_emb == "learned":
            # out-of-range indices: the pad rows of a right-padded suffix bucket
            # can pass the last learned position, where JAX's take fills and a
            # PyTorch lookup asserts; their outputs are never read, so clamp
            pos = positions.long().clamp(0, cfg.max_seq_len - 1)
            x = x + F.embedding(pos, self.wpe).to(cfg.dtype)
        if cfg.embed_layernorm:
            x = self.ln_embed(x).to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, None if caches is None else caches[i], cache_lens,
                      prefix_fill, page_table, kv_cap, train)
        x = self.ln_f(x)
        if logits_positions is not None:
            x = x[torch.arange(b, device=x.device), logits_positions.long()][:, None]
        if cfg.tie_word_embeddings:
            logits = x.float() @ self.wte.float().t()
        else:
            logits = self.lm_head(x.float())
        if caches is None:
            return logits
        return logits, caches


def init_cache(cfg: CausalLMConfig, batch_size: int, max_len: Optional[int] = None,
               dtype=None, device=None) -> List[Dict[str, torch.Tensor]]:
    """Fixed-capacity head-major KV caches ``(b, h_kv, T, d)``, one per layer, zeroed."""
    device = resolve_device(device)
    cap = max_len or cfg.max_seq_len
    shape = (batch_size, cfg.kv_heads, cap, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layer)]


def causal_lm_model(cfg: CausalLMConfig, sample_seq_len: Optional[int] = None) -> Model:
    """A :class:`Model` for the training engine (JAX ``causal_lm_model``):
    batch = ``{"input_ids": (B, T)}`` with optional ``"labels"`` (default: the
    shifted input ids), f32 cross-entropy on the logits of the full-sequence
    forward (``train=True``), run on the engine's parameter dict through
    ``functional_call``. The ALiBi slopes are not parameters: the loss hands
    the module each layer's slopes on the parameters' device. Seeded weights
    from :meth:`CausalLM.init_weights`; on a CUDA device a head_dim the
    training kernels do not take raises ``ValueError`` before anything is
    allocated there. The model draws nothing, so it ignores ``rng``.
    ``causal_lm_segments`` (ZeRO-3 parameter offload) waits for ROADMAP.md
    queue 1 item 12b."""
    from .gpt2 import cross_entropy_loss, shift_labels
    module = CausalLM(cfg, device="meta")
    t = sample_seq_len or min(cfg.max_seq_len, 1024)
    slopes = {}

    def buffers(device) -> Dict[str, torch.Tensor]:
        if cfg.pos_emb != "alibi":
            return {}
        if device not in slopes:
            one = torch.from_numpy(alibi_slopes(cfg.n_head)).to(device)
            slopes[device] = {f"layers.{i}.alibi": one for i in range(cfg.n_layer)}
        return slopes[device]

    def init_fn(seed: int, device) -> Params:
        if torch.device(device).type == "cuda":
            kernel_width(cfg.head_dim, training=True)
        model = CausalLM(cfg, device=device)
        model.init_weights(seed)
        return {k: p.detach() for k, p in model.named_parameters()}

    def loss_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        ids = batch["input_ids"]
        logits = functional_call(module, {**params, **buffers(ids.device)}, (ids,),
                                 {"train": True})
        return cross_entropy_loss(logits, shift_labels(batch))

    def apply_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        return functional_call(module, {**params, **buffers(ids.device)}, (ids,),
                               {"train": True})

    return Model(loss_fn=loss_fn, init_fn=init_fn, apply_fn=apply_fn, name=cfg.name,
                 flops_per_sample=6.0 * cfg.num_params() * t)
