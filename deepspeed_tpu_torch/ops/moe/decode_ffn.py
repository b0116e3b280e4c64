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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..attention.flash import DTYPE_CODES
from ..op_builder import CudaKernel
from ..quantizer.quant import dequantize_grouped, is_quant_node, node_bits, node_qs, unpack_int4

#: the activations of the causal LM (``_act`` of the JAX model), by name
ACTIVATIONS = {"gelu": lambda v: F.gelu(v, approximate="tanh"), "relu": F.relu,
               "silu": F.silu}
ACT_CODES = {"gelu": 0, "relu": 1, "silu": 2}

#: the kernel's plan (:func:`moe_plan`). 16-bit stacks with d and f
#: multiples of 8 run the tensor-core kernel on f-blocks of ``MMA_BLOCK_F``
#: columns where a call holds at most ``MMA_TOKENS`` tokens (at GPT-2 MoE's f
#: 3072 and n 1, 192 blocks of 48 KB of slabs) and its shared memory
#: (:func:`mma_smem_bytes`) fits a block's ``SMEM_MAX``. Every other call
#: runs the first version's slab kernel, each token its own blocks (experts
#: shared by a few tokens come from L2), on the widest of
#: ``BLOCK_F_CHOICES`` for which the blocks reach ``SLAB_TARGET_BLOCKS``,
#: else the narrowest: at those shapes it is the faster (``PERF.md``,
#: ``benchmarks/torch/moe_parts.py``)
MMA_TOKENS = 2
MMA_BLOCK_F = 16
BLOCK_F_CHOICES = (128, 64, 32, 16)
SLAB_TARGET_BLOCKS = 96
MAX_BLOCK_F = 256                # the C entry's limit
SMEM_MAX = 227 * 1024            # a block's shared memory on the H100
SLAB, MMA = 0, 1                 # the C entry's modes

_vp, _int = ctypes.c_void_p, ctypes.c_int
MOE_DECODE_FFN = CudaKernel(
    "moe_decode_ffn", "moe_decode_ffn.cu", "moe_decode_ffn",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,     # x, idx, w1, b1, w2, b2, part, y
     _int, _int, _int, _int, _int, _int,         # n, d, f, e, block_f, mode
     _int, _int, _vp])                           # act, dtype, stream


def mma_smem_bytes(d: int, bf: int) -> int:
    """The tensor-core kernel's dynamic shared memory at width ``d`` and
    f-blocks of ``bf`` (16-bit stacks), as ``mma_layout`` in
    ``csrc/moe_decode_ffn.cu`` lays it out: w2's boxes, w1's boxes, x as 8
    rows of A, the warps' sums of h, h as 8 rows of A, b1's slice, the
    barriers, and 1024 bytes to align the start. About 80 d bytes at bf 16:
    d up to 2,848 fits."""
    at = 0

    def take(size: int, align: int) -> None:
        nonlocal at
        at = -(-at // align) * align + size

    nb, kr = -(-d // 64), max(bf, 16)
    take(nb * kr * 128, 1024)           # w2: cdiv(d, 64) boxes of kr rows x 128 bytes
    take(nb * 64 * bf * 2, 1024)        # w1: cdiv(d, 64) boxes of 64 rows x bf
    take(8 * (d + 8) * 2, 16)           # x
    take(8 * bf * 4, 16)                # the 8 warps' sums of h
    take(8 * (kr + 8) * 2, 16)          # h
    take(bf * 4, 16)                    # b1
    take((nb + 1) * 8, 8)               # the barriers
    return at + 1024


def moe_plan(n: int, d: int, f: int, itemsize: int) -> Tuple[int, int]:
    """``(block_f, mode)`` for ``n`` tokens, from the shapes alone (no host
    read of ``idx``): see :data:`MMA_TOKENS`."""
    if itemsize == 2 and d % 8 == 0 and f % 8 == 0 and n <= MMA_TOKENS and \
            mma_smem_bytes(d, MMA_BLOCK_F) <= SMEM_MAX:
        return MMA_BLOCK_F, MMA
    for bf in BLOCK_F_CHOICES:
        if n * -(-f // bf) >= SLAB_TARGET_BLOCKS:
            return bf, SLAB
    return BLOCK_F_CHOICES[-1], SLAB


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
    ``block_f``: the f-block width (default :func:`moe_plan`'s; another
    width runs the slab kernel). The FFN kernel and the reduction over
    f-blocks, with no host synchronisation."""
    _check(x, idx, w1, b1, w2, b2, activation)
    if x.device.type == "cpu":
        return moe_decode_ffn_plain(x, idx, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"moe_decode_ffn runs on cuda or cpu tensors, not {x.device}")
    if any(t.device != x.device for t in (idx, w1, b1, w2, b2)):
        raise ValueError("x, idx and the expert weights must be on one device")
    n, d = x.shape
    e, _, f = w1.shape
    bf, mode = moe_plan(n, d, f, x.element_size())
    if block_f is not None:
        bf, mode = block_f, mode if block_f == bf else SLAB
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
        b2.data_ptr(), part.data_ptr(), y.data_ptr(), n, d, f, e, bf, mode,
        ACT_CODES[activation], DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
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
