"""Selected-expert MoE FFN for the decode step: the hand-written Hopper kernel
``csrc/moe_decode_ffn.cu`` (K7), its plain PyTorch version, the gather path
and the quantized-expert path.

Counterpart of ``deepspeed_tpu/ops/moe/decode_ffn.py``. A decode step carries
one token a sequence, so the FFN touches ``n = b * k`` expert slices of the
stacked ``(e, d, f)`` weights. :func:`moe_decode_ffn` launches K7 for CUDA
tensors, which streams each selected expert's weights from device memory
once, and runs :func:`moe_decode_ffn_plain` for CPU tensors only. The kernel
takes every shape, so there is no fallback (the TPU wrapper falls back to
XLA where no block size fits). :func:`moe_decode_ffn_xla` is the JAX gather
path (``moe_decode_impl="xla"``): ``w[idx]`` copies, then batched products
rounded in the serve dtype. :func:`moe_decode_ffn_quant` runs quantized
expert stacks in plain tensor code, as the JAX package runs it outside any
Pallas kernel.

Where JAX passes the activation as a function, these take its name
(``"gelu"`` tanh, ``"relu"``, ``"silu"``; :data:`ACTIVATIONS`), since the
kernel needs a code.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..attention.flash import DTYPE_CODES
from ..op_builder import CudaKernel
from ..quantizer.quant import dequantize_grouped, is_quant_node, node_bits, node_qs, unpack_int4

#: the activations of the causal LM (``_act`` of the JAX model), by name
ACTIVATIONS = {"gelu": lambda v: F.gelu(v, approximate="tanh"), "relu": F.relu,
               "silu": F.silu}
ACT_CODES = {"gelu": 0, "relu": 1, "silu": 2}

#: f-block widths the kernel is tuned over; :func:`pick_block_f` takes the
#: widest that still gives ``TARGET_BLOCKS`` blocks, else the narrowest.
#: From the sweep on the H100 at GPT-2 MoE's d 768, f 3072 (``chip_smoke.py``
#: ``[check]``, ``PERF.md``): at n = 1, widths 16, 32 and 64 (192, 96 and 48
#: blocks) within 5 % of each other and 128 about 20 % slower; at n = 16, 128
#: (384 blocks) fastest, 16 nearly twice as slow (more f32 partials)
BLOCK_F_CHOICES = (128, 64, 32, 16)
TARGET_BLOCKS = 96
MAX_BLOCK_F = 256                # the C entry's limit

_vp, _int = ctypes.c_void_p, ctypes.c_int
MOE_DECODE_FFN = CudaKernel(
    "moe_decode_ffn", "moe_decode_ffn.cu", "moe_decode_ffn",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,     # x, idx, w1, b1, w2, b2, part, y
     _int, _int, _int, _int, _int, _int, _int,   # n, d, f, e, block_f, act, dtype
     _vp])                                       # stream


def pick_block_f(n: int, f: int) -> int:
    """The kernel's f-block width: the widest of :data:`BLOCK_F_CHOICES` for
    which ``n * cdiv(f, bf)`` blocks reach :data:`TARGET_BLOCKS`, else the
    narrowest. At f 3072 that is 32 at n = 1 (96 blocks), 64 at n = 2 and
    128 at n = 16 (384): narrow blocks spread a batch of one over the SMs,
    wide ones write fewer f32 partials when tokens already fill the card."""
    for bf in BLOCK_F_CHOICES:
        if n * -(-f // bf) >= TARGET_BLOCKS:
            return bf
    return BLOCK_F_CHOICES[-1]


def _check(x, idx, w1, b1, w2, b2, activation):
    if activation not in ACT_CODES:
        raise ValueError(f"activation {activation!r} is not one of {list(ACT_CODES)}")
    if x.ndim != 2 or w1.ndim != 3:
        raise ValueError(f"need x (n, d) and w1 (e, d, f), got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    n, d = x.shape
    e, _, f = w1.shape
    want = {"idx": (n,), "w1": (e, d, f), "b1": (e, f), "w2": (e, f, d), "b2": (e, d)}
    got = {"idx": idx, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    bad = [f"{k} {tuple(got[k].shape)} != {v}" for k, v in want.items()
           if tuple(got[k].shape) != v]
    if bad:
        raise ValueError("moe_decode_ffn: " + "; ".join(bad))
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise TypeError(f"x, w1, b1, w2 and b2 must share one of {list(DTYPE_CODES)}, got "
                        f"{[t.dtype for t in (x, w1, b1, w2, b2)]}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")


def moe_decode_ffn(x: torch.Tensor, idx: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, activation: str = "gelu",
                   block_f: Optional[int] = None) -> torch.Tensor:
    """Selected-expert FFN: ``(n, d)`` tokens → ``(n, d)`` f32, ``y_i =
    act(x_i @ w1[idx_i] + b1[idx_i]) @ w2[idx_i] + b2[idx_i]``; the caller
    applies the gate weights. ``idx (n,)`` integer expert ids, read by the
    kernel from device memory (no host synchronisation); weights stacked
    ``(e, d, f)`` / ``(e, f)`` / ``(e, f, d)`` / ``(e, d)`` in x's dtype.
    ``block_f``: the kernel's f-block width (default :func:`pick_block_f`)."""
    _check(x, idx, w1, b1, w2, b2, activation)
    if x.device.type == "cpu":
        return moe_decode_ffn_plain(x, idx, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"moe_decode_ffn runs on cuda or cpu tensors, not {x.device}")
    if any(t.device != x.device for t in (idx, w1, b1, w2, b2)):
        raise ValueError("x, idx and the expert weights must be on one device")
    n, d = x.shape
    e, _, f = w1.shape
    bf = block_f or pick_block_f(n, f)
    if not 1 <= bf <= MAX_BLOCK_F:
        raise ValueError(f"block_f={bf} not in [1, {MAX_BLOCK_F}]")
    y = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    idx = idx.to(torch.int32).contiguous()
    part = torch.empty(n, -(-f // bf), d, dtype=torch.float32, device=x.device)
    MOE_DECODE_FFN.launch(
        x.data_ptr(), idx.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), part.data_ptr(), y.data_ptr(), n, d, f, e, bf, ACT_CODES[activation],
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    return y


def moe_decode_ffn_plain(x: torch.Tensor, idx: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                         activation: str = "gelu") -> torch.Tensor:
    """The kernel's function in plain tensor code, as the TPU ``_kernel``
    computes it: both products of the stored values with f32 accumulation, b1
    and the activation in f32, h rounded once to the weights' dtype, b2 in
    f32. Returns f32 ``(n, d)``."""
    act = ACTIVATIONS[activation]
    idx = idx.long()
    h = torch.einsum("nd,ndf->nf", x.float(), w1[idx].float()) + b1[idx].float()
    h = act(h).to(w2.dtype).float()
    return torch.einsum("nf,nfd->nd", h, w2[idx].float()) + b2[idx].float()


def moe_decode_ffn_xla(x: torch.Tensor, idx: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       activation: str = "gelu") -> torch.Tensor:
    """The JAX gather path, with its numerics: gather the selected experts'
    weights, then products and bias adds in x's dtype (each rounded to it).
    Returns f32 ``(n, d)``."""
    act = ACTIVATIONS[activation]
    cdtype = x.dtype
    idx = idx.long()
    h = torch.einsum("nm,nmf->nf", x, w1[idx].to(cdtype)) + b1[idx].to(cdtype)
    out = torch.einsum("nf,nfm->nm", act(h), w2[idx].to(cdtype)) + b2[idx].to(cdtype)
    return out.float()


def _gather_expert(w, idx: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """Per-token expert slices of a stacked weight that may be a quant node:
    a quantized stack gathers its int8 (or packed int4) payload and its
    scales, then dequantizes only the gathered ``(n, ...)`` slices."""
    if not is_quant_node(w):
        return w[idx].to(cdtype)
    q, s = node_qs(w)
    qg, sg = q[idx], s[idx]
    if node_bits(w) == 4:
        qg = unpack_int4(qg, s.shape[-2])
    return dequantize_grouped(qg, sg).to(cdtype)


def moe_decode_ffn_quant(x: torch.Tensor, idx: torch.Tensor, w1, b1: torch.Tensor, w2,
                         b2: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    """:func:`moe_decode_ffn_xla` where ``w1``/``w2`` may be quant nodes
    (``b1``/``b2`` are always fp). Per-expert grouped scales ride the gather,
    so the numerics equal dequantize-then-gather exactly. Returns f32
    ``(n, d)``."""
    act = ACTIVATIONS[activation]
    cdtype = x.dtype
    idx = idx.long()
    h = torch.einsum("nm,nmf->nf", x, _gather_expert(w1, idx, cdtype)) + b1[idx].to(cdtype)
    out = torch.einsum("nf,nfm->nm", act(h), _gather_expert(w2, idx, cdtype)) + \
        b2[idx].to(cdtype)
    return out.float()
