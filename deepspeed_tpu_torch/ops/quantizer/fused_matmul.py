"""Dequant-GEMM: the hand-written Hopper kernel ``csrc/quantized_matmul.cu``,
its plain PyTorch version, and the model-facing ``quant_dense_apply``.

Counterpart of ``deepspeed_tpu/ops/quantizer/fused_matmul.py``.
:func:`quantized_matmul` launches the kernel for CUDA tensors and runs
:func:`quantized_matmul_plain` for CPU tensors only. The kernel takes every
shape the quantizer makes (any m, n, k; any group dividing k; even groups for
int4), so there is no fallback and no counterpart of ``DS_TPU_WQ_FORCE_FUSED``.
Nor is there a mesh branch: tensor parallelism is not ported (ROADMAP.md
queue 1 item 11) and the config refuses it.

Numerics follow the TPU kernel ``_qmm_kernel``: each weight element is
dequantized in f32 and rounded to x's dtype before an f32-accumulated
product. (``quantized_matmul_xla`` keeps w in f32, the JAX engine's CPU
fallback multiplies in the serve dtype; in f32 all three agree.)
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..attention.flash import DTYPE_CODES
from ..op_builder import CudaKernel
from .quant import (dequantize_grouped, node_bits, node_qs, unpack_int4)

#: the row count up to which the kernel runs its skinny (decode) regime: one
#: 32-bit payload load a row per thread, m accumulators for each of its 4
#: columns in registers (64 at m = 16), split-k across blocks. Above it the
#: tiled regime stages 64-row tiles and runs the tensor cores. The decode
#: rows of the port's main paths are 1 to 4 (``generate``) and 16 (the
#: scheduler's slots); prefill rows are 8 and up (buckets) and 512.
SKINNY_M = 16
#: skinny split-k: aim for this many blocks (4 of 128 threads per SM on 132 SMs)
_SKINNY_TARGET_BLOCKS = 4 * 132
_SKINNY_THREADS, _SKINNY_COLS = 128, 4

_vp, _int = ctypes.c_void_p, ctypes.c_int
QUANTIZED_MATMUL = CudaKernel(
    "quantized_matmul", "quantized_matmul.cu", "quantized_matmul",
    [_vp, _vp, _vp, _vp, _vp,                 # x, q, scales, out, work
     _int, _int, _int, _int, _int, _int,      # m, k, n, group, bits, chunk
     _int, _vp])                              # dtype, stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def skinny_split(m: int, k: int, n: int, bits: int) -> Tuple[int, int]:
    """``(chunk, splits)`` of the skinny regime: payload rows a block walks,
    and the blocks along k. Enough splits that the column blocks times the
    splits reach ``_SKINNY_TARGET_BLOCKS``, but at most ``rows / (8 m)``, so
    the f32 partials (splits x m x n, written and read back) stay under half
    the payload's bytes; chunks are multiples of 8 rows (the row loop's
    unroll). ``(0, 1)`` for the tiled regime (m > ``SKINNY_M``)."""
    if m > SKINNY_M:
        return 0, 1
    prow = k if bits == 8 else k // 2
    col_blocks = _cdiv(_cdiv(n, _SKINNY_COLS), _SKINNY_THREADS)
    splits = max(1, min(_cdiv(_SKINNY_TARGET_BLOCKS, col_blocks), prow // (8 * m),
                        _cdiv(prow, 32)))
    chunk = _cdiv(_cdiv(prow, splits), 8) * 8
    return chunk, _cdiv(prow, chunk)


def _check(x, q, scales, bits):
    if bits not in (8, 4):
        raise ValueError(f"quantized_matmul: bits={bits} not in (8, 4)")
    if x.ndim != 2 or q.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"need x (m, k), q 2-D and scales (k/g, n), got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")
    m, k = x.shape
    groups, n = scales.shape
    if groups < 1 or k % groups:
        raise ValueError(f"scales {tuple(scales.shape)}: {groups} groups do not divide k={k}")
    rows = k if bits == 8 else k // 2
    if tuple(q.shape) != (rows, n) or (bits == 4 and (k // groups) % 2):
        raise ValueError(f"int{bits} payload for x {tuple(x.shape)} and {groups} groups must "
                         f"be ({rows}, {n})" + (" with an even group" if bits == 4 else "")
                         + f", got {tuple(q.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"need an int8 payload and f32 scales, got {q.dtype}, {scales.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be one of {list(DTYPE_CODES)}, got {x.dtype}")


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *, bits: int = 8,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x (m, k) @ dequant(q, scales) → (m, n)`` in ``out_dtype`` (default x's).

    ``q``: int8 ``(k, n)`` (bits 8) or packed ``(k//2, n)`` (bits 4);
    ``scales``: f32 ``(k//g, n)``. f32 accumulation, w rounded to x's dtype."""
    _check(x, q, scales, bits)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scales, bits=bits, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cuda or cpu tensors, not {x.device}")
    if q.device != x.device or scales.device != x.device:
        raise ValueError("x, q and scales must be on one device")
    m, k = x.shape
    groups, n = scales.shape
    x = x.contiguous()
    q = q.contiguous()
    scales = scales.contiguous()
    if q.data_ptr() % 4:
        raise ValueError("quantized_matmul kernel takes a 4-byte-aligned payload")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m == 0:
        return out.to(out_dtype)
    chunk, splits = skinny_split(m, k, n, bits)
    work = torch.empty(splits, m, n, dtype=torch.float32, device=x.device) \
        if splits > 1 else out
    QUANTIZED_MATMUL.launch(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(), work.data_ptr(),
        m, k, n, k // groups, bits, chunk, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    return out.to(out_dtype)


def dequantize_to(q: torch.Tensor, scales: torch.Tensor, bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The weight ``(k, n)`` the kernel multiplies by: dequantized in f32,
    rounded to ``dtype``."""
    if bits == 4:
        q = unpack_int4(q, scales.shape[-2])
    return dequantize_grouped(q, scales).to(dtype)


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
                           bits: int = 8,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain tensor code, as ``_qmm_kernel``: w
    dequantized in f32 and rounded to x's dtype, then an f32 product."""
    out_dtype = out_dtype or x.dtype
    w = dequantize_to(q, scales, bits, x.dtype)
    return (x.float() @ w.float()).to(out_dtype)


# ------------------------------------------------------------ bytes accounting
def node_weight_bytes(node) -> int:
    """Bytes the kernel streams for one pass over a quant node: the payload
    and the scales, each read once."""
    q, s = node_qs(node)
    return q.numel() * q.element_size() + s.numel() * s.element_size()


def dense_weight_bytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


# --------------------------------------------------------------- model entry
def quant_dense_apply(x: torch.Tensor, node, bias: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """Dense ``y = x @ W + b`` where ``W`` is a quant node, on one device:
    ``x`` ``(b, t, k)`` or ``(m, k)`` in any float dtype, cast to ``dtype``;
    the product in ``dtype`` through :func:`quantized_matmul`; the bias cast
    to ``dtype`` and added there."""
    bits = node_bits(node)
    q, s = node_qs(node)
    lead = x.shape[:-1]
    y = quantized_matmul(x.to(dtype).reshape(-1, x.shape[-1]), q, s, bits=bits,
                         out_dtype=dtype).reshape(*lead, q.shape[-1])
    return y if bias is None else y + bias.to(dtype)
