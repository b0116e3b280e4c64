"""Unified causal-LM family with KV-cache serving, in PyTorch.

Counterpart of ``deepspeed_tpu/models/causal_lm.py``: one configurable
transformer covers the families (learned/rotary/ALiBi positions, parallel
residual, GQA, gated MLP, pre-LN with LayerNorm or RMSNorm), and per-family
constructors pin the knobs. Prefill attention goes through the flash kernel
(``ops/attention/flash.py``); decode attention goes through the decode kernel
(``ops/attention/decode.py``) against a head-major ``(b, h_kv, T, d)`` cache,
except ALiBi (BLOOM) decode, which is plain tensor code as in the JAX package.

Parameters follow the JAX tree's names. A projection's ``weight`` is
``(out, in)``, the flax ``kernel`` transposed (``models/convert.py``). Norms run
in f32; 1-D parameters stay f32 when the engine casts the rest to the serve
dtype, and are cast where they are used.

The KV caches are updated in place: prefill writes rows ``[0, t)``, a decode
step writes one row per sequence at ``cache_len`` (clamped to ``T - 1``, as
``dynamic_update_slice`` clamps), so no second cache is ever allocated.

Not in this slice (each raises ``NotImplementedError``): MoE layers, paged
caches and suffix prefill, quantized projections, tensor parallelism.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import resolve_device
from ..ops.attention.decode import decode_attention
from ..ops.attention.flash import flash_attention


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
    # MoE serving is not ported yet (ROADMAP.md queue 1 item 10): num_experts > 0 raises
    num_experts: int = 0
    moe_layer_interval: int = 2
    moe_top_k: int = 1

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


_ACTIVATIONS = {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu,
                "silu": F.silu}


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


class CausalLMLayer(nn.Module):
    def __init__(self, cfg: CausalLMConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.n_embd, cfg.head_dim, cfg.dtype
        self.ln_attn = _norm(cfg, device)
        self.q_proj = Dense(d, cfg.n_head * hd, cfg.qkv_bias, dt, device)
        self.k_proj = Dense(d, cfg.kv_heads * hd, cfg.qkv_bias, dt, device)
        self.v_proj = Dense(d, cfg.kv_heads * hd, cfg.qkv_bias, dt, device)
        # o_proj's bias follows mlp_bias, as in the JAX layer
        self.o_proj = Dense(d, d, cfg.mlp_bias, dt, device)
        self.ln_mlp = _norm(cfg, device)
        if cfg.gated_mlp:
            self.gate_proj = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
            self.up_proj = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
        else:
            self.fc_in = Dense(d, cfg.ffn_dim, cfg.mlp_bias, dt, device)
        self.fc_out = Dense(cfg.ffn_dim, d, cfg.mlp_bias, dt, device)
        self.act = _ACTIVATIONS[cfg.activation]
        slopes = (torch.from_numpy(alibi_slopes(cfg.n_head)).to(device)
                  if cfg.pos_emb == "alibi" else None)
        self.register_buffer("alibi", slopes, persistent=False)

    def _mlp(self, h):
        if self.cfg.gated_mlp:
            h = self.act(self.gate_proj(h)) * self.up_proj(h)
        else:
            h = self.act(self.fc_in(h))
        return self.fc_out(h)

    def forward(self, x, positions, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[torch.Tensor] = None):
        """x ``(b, t, d)``. With ``cache`` and t == 1 (decode): write this step's
        K/V at row ``cache_len`` and attend over rows ``[0, cache_len]``. With
        ``cache`` and t > 1 (prefill): attend over the prompt and write its K/V
        into rows ``[0, t)``."""
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

        if cache is not None and t == 1:
            cache_update(cache["k"], k.transpose(1, 2), cache_len)
            cache_update(cache["v"], v.transpose(1, 2), cache_len)
            lens = cache_len + 1
            q1 = q[:, 0].contiguous()
            if self.alibi is not None:
                o = decode_attention_alibi_plain(q1, cache["k"], cache["v"], lens, self.alibi)
            else:
                o = decode_attention(q1, cache["k"], cache["v"], lens)
            o = o[:, None]
        else:
            o = bias_attention(q, k, v, self.alibi)
            if cache is not None:
                cache["k"][:, :, :t] = k.transpose(1, 2)
                cache["v"][:, :, :t] = v.transpose(1, 2)
        attn_out = self.o_proj(o.reshape(b, t, cfg.n_embd))

        if cfg.parallel_residual:
            return x + attn_out + self._mlp(self.ln_mlp(x).to(cfg.dtype))
        x = x + attn_out
        return x + self._mlp(self.ln_mlp(x).to(cfg.dtype))


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
        if cfg.num_experts > 0:
            raise NotImplementedError("MoE layers (num_experts > 0) are not ported yet: "
                                      "ROADMAP.md queue 1 item 10")
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd, device=device))
        if cfg.pos_emb == "learned":
            self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.n_embd, device=device))
        if cfg.embed_layernorm:
            self.ln_embed = _norm(cfg, device)
        self.layers = nn.ModuleList(CausalLMLayer(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = _norm(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.n_embd, cfg.vocab_size, cfg.lm_head_bias,
                                 torch.float32, device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random weights with the JAX model's initialisers: normal with
        ``init_std`` for embeddings and projections, ``init_std / sqrt(2 *
        n_layer)`` for ``o_proj``/``fc_out``, zero biases, unit norm scales. One
        ``torch.Generator`` on the parameters' device, seeded with ``seed``."""
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
        self.wte.normal_(0.0, cfg.init_std, generator=gen)
        if cfg.pos_emb == "learned":
            self.wpe.normal_(0.0, cfg.init_std, generator=gen)

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Dict[str, torch.Tensor]]] = None,
                cache_lens: Optional[torch.Tensor] = None,
                logits_positions: Optional[torch.Tensor] = None,
                prefix_fill: bool = False, page_table=None):
        """``input_ids (b, t)`` → f32 logits ``(b, t, V)``, or ``(b, 1, V)`` read
        only at ``logits_positions (b,)``. With ``caches`` (from
        :func:`init_cache`, updated in place) returns ``(logits, caches)``."""
        if prefix_fill or page_table is not None:
            raise NotImplementedError("suffix prefill and paged KV caches are not ported "
                                      "yet: ROADMAP.md queue 1 item 6")
        cfg = self.cfg
        b, t = input_ids.shape
        if positions is None:
            positions = torch.arange(t, device=input_ids.device)[None].expand(b, t)
        x = F.embedding(input_ids.long(), self.wte).to(cfg.dtype)
        if cfg.pos_emb == "learned":
            x = x + F.embedding(positions.long(), self.wpe).to(cfg.dtype)
        if cfg.embed_layernorm:
            x = self.ln_embed(x).to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, None if caches is None else caches[i], cache_lens)
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
