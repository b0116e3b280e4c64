"""GPT-2, the training main path's model, in PyTorch.

Counterpart of ``deepspeed_tpu/models/gpt2.py`` (``GPT2Config``, ``Block``,
``GPT2``, ``cross_entropy_loss``, ``gpt2_model``), with its numerics:

- the residual stream is in the compute dtype: token and position embeddings
  are each cast to it and added there, and each block adds in it;
- LayerNorm runs in f32 as flax's does: epsilon 1e-6, variance E[x^2] -
  E[x]^2 clamped at 0, then the output is cast to the compute dtype;
- a Dense casts its kernel and bias to the compute dtype, multiplies, then
  adds the bias in that dtype; GELU is the tanh approximation;
- the head is tied to ``wte``: the product of compute-dtype operands is taken
  to f32 (``.float()`` of the product), and the loss is f32 cross-entropy
  with ``-100`` labels masked.

Attention comes from ``ops/transformer/attention.py:get_attention_impl``:
``auto`` (the default) runs the flash kernels forward and backward.

``dropout > 0`` applies dropout where the JAX model does (``gpt2.py:110-127,
351``): after the embeddings, to the attention probabilities, after
``c_proj`` and after the MLP, each mask drawn from a key of the engine's
random stream (``runtime/rng.py``) folded with the layer and the site, so a
recompute under remat draws the same masks. Attention dropout goes through
the attention impl's ``dropout_rate``/``dropout_rng``: the flash impl sends it
to the plain attention, as JAX's does, so no flash kernel launches in a
training step with dropout. A forward without a key (``apply_fn``) is
deterministic; the loss (``loss_fn``) applies dropout whenever it gets one,
as JAX's ``deterministic=False`` loss does, in ``eval_batch`` too.

Parameters follow the JAX tree's names (``models/convert.py`` carries them
across): a Dense ``weight`` is ``(out, in)``, the flax ``kernel`` transposed.
The blocks are ``h.0`` .. ``h.{n_layer-1}`` whether the JAX model scanned its
layers or not, so ``scan_layers`` has no counterpart here.

``remat=True`` runs each block through ``checkpointing.checkpoint``
(``runtime/activation_checkpointing``): ``remat_policy="full"`` saves nothing
and recomputes the block in the backward, ``"dots"`` saves the projections'
products (``dots_with_no_batch_dims_saveable``, as JAX's) and recomputes the
rest, and ``"offload_dots"`` keeps dots' products in pinned host memory;
the flash forward runs again in the backward under each. The model never
reads ``checkpointing.configure``'s settings: the config alone names the
policy. The block takes its parameters as arguments and binds them itself,
because the recompute runs after ``functional_call`` has unbound the
model's. ``vocab_chunk > 0`` takes
the training loss through ``runtime/zero/tiling.py:
chunked_vocab_cross_entropy`` from ``GPT2(..., return_hidden=True)``, without
the ``(b, t, V)`` logits. Not ported yet: the TP and SP block variants and
``gpt2_param_specs`` (ROADMAP.md queue 1 item 11).
"""

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.attention.flash import kernel_width
from ..ops.transformer.attention import get_attention_impl
from ..runtime.activation_checkpointing import checkpointing
from ..runtime.rng import dropout, site_key
from ..runtime.zero.tiling import chunked_vocab_cross_entropy
from .base import Model, Params

#: ``GPT2Config.remat_policy`` -> the ``checkpointing`` policy of a block
_BLOCK_POLICY = {"full": "nothing_saveable", "dots": "dots_with_no_batch_dims_saveable",
                 "offload_dots": "offload_dots"}
#: dropout sites: under the forward's key, the embeddings' and each block's
#: (folded with the layer index); under a block's key, its three sites and
#: an MoE block's gating noise
SITE_EMBD, SITE_BLOCKS = 0, 1
SITE_ATTN, SITE_ATTN_OUT, SITE_MLP_OUT, SITE_GATING = 0, 1, 2, 3


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16       # compute dtype
    remat: bool = False
    # full | dots (save the projections' products) | offload_dots (dots' products
    # kept in pinned host memory)
    remat_policy: str = "full"
    attention_impl: str = "auto"
    init_std: float = 0.02
    split_qkv: bool = False
    # > 0: the training loss through the chunked-vocab cross-entropy over vocab
    # slices of this size, without the (b, t, V) logits (6.6 GB in f32 at seq
    # 32k and vocab 50k)
    vocab_chunk: int = 0

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"GPT2Config.dropout must be in [0, 1), got {self.dropout}")
        if self.remat_policy not in _BLOCK_POLICY:
            raise ValueError(f"GPT2Config.remat_policy must be one of {sorted(_BLOCK_POLICY)}, "
                             f"got {self.remat_policy!r}")
        if self.vocab_chunk < 0:
            raise ValueError(f"GPT2Config.vocab_chunk must be >= 0, got {self.vocab_chunk}")
        get_attention_impl(self.attention_impl)     # an unported impl raises here

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def flops_per_token(self) -> float:
        # 6ND training-flops rule + attention quadratic term
        n = self.num_params()
        return 6.0 * n + 12.0 * self.n_layer * self.n_embd * self.n_positions

    def num_params(self) -> int:
        d, L, v, t = self.n_embd, self.n_layer, self.vocab_size, self.n_positions
        return v * d + t * d + L * (12 * d * d + 13 * d) + 2 * d


GPT2_PRESETS = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=16),
    "gpt2-2.7b": dict(n_embd=2560, n_layer=32, n_head=32),
    "gpt2-6.7b": dict(n_embd=4096, n_layer=32, n_head=32),
    "gpt2-13b": dict(n_embd=5120, n_layer=40, n_head=40),
}


def gpt2_config(preset: str, **overrides) -> GPT2Config:
    kw = dict(GPT2_PRESETS[preset])
    kw.update(overrides)
    return GPT2Config(**kw)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 output, ``weight`` = flax ``scale``."""

    def __init__(self, dim: int, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``: kernel and bias cast to ``dtype``, the
    bias added after the product, in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.n_embd, cfg.dtype
        self.attn = get_attention_impl(cfg.attention_impl)
        self.ln_1 = LayerNorm(d, device)
        self.split_qkv = cfg.split_qkv
        if cfg.split_qkv:
            self.q_attn = Dense(d, d, dt, device)
            self.k_attn = Dense(d, d, dt, device)
            self.v_attn = Dense(d, d, dt, device)
        else:
            self.c_attn = Dense(d, 3 * d, dt, device)
        self.c_proj = Dense(d, d, dt, device)
        self.ln_2 = LayerNorm(d, device)
        self.c_fc = Dense(d, 4 * d, dt, device)
        self.mlp_c_proj = Dense(4 * d, d, dt, device)

    def attend(self, x, key: Optional[int]):
        """``x`` plus the attention branch (dropout on the probabilities and
        after ``c_proj`` under ``key``)."""
        cfg = self.cfg
        b, t, d = x.shape
        h = self.ln_1(x).to(cfg.dtype)
        if self.split_qkv:
            q, k, v = self.q_attn(h), self.k_attn(h), self.v_attn(h)
        else:
            q, k, v = self.c_attn(h).split(d, dim=-1)
        shape = (b, t, cfg.n_head, cfg.head_dim)
        rate = cfg.dropout if key is not None else 0.0
        o = self.attn(q.reshape(shape), k.reshape(shape), v.reshape(shape), causal=True,
                      dropout_rate=rate, dropout_rng=site_key(key, SITE_ATTN) if rate else None)
        return x + dropout(self.c_proj(o.reshape(b, t, d)), cfg.dropout,
                           site_key(key, SITE_ATTN_OUT))

    def forward(self, x, key: Optional[int] = None):
        cfg = self.cfg
        x = self.attend(x, key)
        h = self.ln_2(x).to(cfg.dtype)
        h = self.mlp_c_proj(F.gelu(self.c_fc(h), approximate="tanh"))
        return x + dropout(h, cfg.dropout, site_key(key, SITE_MLP_OUT))


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd, device=device))
        self.h = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, device)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False,
                rng: Optional[int] = None):
        """``input_ids (b, t)`` → f32 logits ``(b, t, vocab)``; with
        ``return_hidden``, ``(f32 hidden states after ln_f, wte)`` for the
        chunked-vocab loss. ``rng``: the random stream's key (dropout), None
        for a deterministic forward."""
        cfg = self.cfg
        x = embed(self, input_ids, rng)
        for i, block in enumerate(self.h):
            key = site_key(rng, SITE_BLOCKS, i)
            if cfg.remat:
                x = checkpointing.checkpoint(functools.partial(_run_block, block, key=key), x,
                                             dict(block.named_parameters()),
                                             policy=_BLOCK_POLICY[cfg.remat_policy])
            else:
                x = block(x, key)
        x = self.ln_f(x)
        if return_hidden:
            return x, self.wte
        dt = cfg.dtype
        return torch.matmul(x.to(dt), self.wte.to(dt).t()).float()


def embed(model: nn.Module, input_ids: torch.Tensor, rng: Optional[int]) -> torch.Tensor:
    """Token plus position embeddings in the compute dtype, then the
    embeddings' dropout (``model`` holds ``wte``, ``wpe`` and ``cfg``)."""
    cfg = model.cfg
    t = input_ids.shape[1]
    x = (F.embedding(input_ids.long(), model.wte).to(cfg.dtype)
         + model.wpe[:t][None].to(cfg.dtype))
    return dropout(x, cfg.dropout, site_key(rng, SITE_EMBD))


def _run_block(block: Block, x: torch.Tensor, params: Params,
               key: Optional[int] = None) -> torch.Tensor:
    return functional_call(block, params, (x, key))


def init_params(cfg: GPT2Config, seed: int, device, module: Optional[nn.Module] = None
                ) -> Params:
    """Seeded f32 parameters of ``module`` (default: GPT-2 of ``cfg``, built on
    the meta device) with the JAX model's initialisers: normal with
    ``init_std`` for the embeddings, projections, MoE gate and expert stacks,
    ``init_std / sqrt(2 * n_layer)`` for the residual projections (``c_proj``,
    ``mlp_c_proj``), lecun-normal scale ``1 / sqrt(fan_in)`` for residual MoE's
    ``coefficient`` (flax's default kernel init; a plain normal, not
    truncated), zero biases, unit LayerNorm scales. One ``torch.Generator``
    on ``device``. On a CUDA device a head_dim the training kernels do not
    take raises ``ValueError`` first, before anything reaches the card."""
    if torch.device(device).type == "cuda" and cfg.attention_impl != "xla":
        kernel_width(cfg.head_dim, training=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    proj_std = cfg.init_std / (2 * cfg.n_layer) ** 0.5
    params = {}
    for name, p in (module or GPT2(cfg, device="meta")).named_parameters():
        x = torch.empty(p.shape, dtype=torch.float32, device=device)
        module_name, _, kind = name.rpartition(".")
        owner = module_name.rsplit(".", 1)[-1]          # "" for wte and wpe
        if owner.startswith("ln_"):
            x.fill_(1.0) if kind == "weight" else x.zero_()
        elif kind in ("bias", "b1", "b2"):
            x.zero_()
        elif owner == "coefficient":
            x.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
        else:
            std = proj_std if owner in ("c_proj", "mlp_c_proj") else cfg.init_std
            x.normal_(0.0, std, generator=gen)
        params[name] = x
    return params


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Next-token cross-entropy in f32, mean over the labels that are not
    ``ignore_index`` (0 when there are none)."""
    nll = F.cross_entropy(logits.flatten(0, -2).float(), labels.flatten().long(),
                          ignore_index=ignore_index, reduction="sum")
    return nll / (labels != ignore_index).sum().clamp(min=1)


def shift_labels(batch: Dict[str, Any]) -> torch.Tensor:
    """``batch["labels"]``, else the input ids shifted left with ``-100``
    appended."""
    if "labels" in batch:
        return batch["labels"]
    ids = batch["input_ids"]
    return torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)], dim=1)


def gpt2_model(config: GPT2Config, sample_seq_len: Optional[int] = None) -> Model:
    """A :class:`Model` for the engine: batch = ``{"input_ids": (B, T)}`` with
    optional ``"labels"`` (default: the shifted input ids)."""
    module = GPT2(config, device="meta")        # structure only; params come per call
    t = sample_seq_len or config.n_positions

    def loss_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        if config.vocab_chunk:
            hidden, wte = functional_call(module, params, (batch["input_ids"],),
                                          {"return_hidden": True, "rng": rng})
            return chunked_vocab_cross_entropy(hidden, wte, shift_labels(batch),
                                               chunk=config.vocab_chunk,
                                               compute_dtype=config.dtype)
        logits = functional_call(module, params, (batch["input_ids"],), {"rng": rng})
        return cross_entropy_loss(logits, shift_labels(batch))

    def apply_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        return functional_call(module, params, (ids,))

    return Model(loss_fn=loss_fn,
                 init_fn=lambda seed, device: init_params(config, seed, device),
                 apply_fn=apply_fn, flops_per_sample=config.flops_per_token() * t,
                 name=f"GPT2(L{config.n_layer},d{config.n_embd})")
