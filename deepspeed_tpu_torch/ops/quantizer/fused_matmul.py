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
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..attention.flash import DTYPE_CODES
from ..op_builder import CudaKernel
from .quant import (dequantize_grouped, node_bits, node_qs, unpack_int4)

#: float32 x: the row count up to which the first version's CUDA-core
#: ``qmm_skinny`` runs (m accumulators for each of a thread's 4 columns, 64 at
#: m = 16; split-k across blocks); above it ``qmm_tiled``
SKINNY_M = 16
#: bf16/fp16 x: the rows of x a block covers (wgmma's N), by m: 8 or 16 at
#: decode, m tiles of ``QMM_WIDE`` at prefill; a block covers
#: ``QMM_BLOCK_COLS`` output features (two consumer warpgroups of 64)
QMM_WIDE = 128
QMM_TILES = (8, 16, QMM_WIDE)
QMM_BLOCK_COLS = 128
#: payload rows of a stage of the wgmma kernel (128 logical k rows)
QMM_STAGE_ROWS = {8: 128, 4: 64}
_SMS = 132
#: blocks the kernel keeps resident on an SM (its ``__launch_bounds__``); a
#: split plan fills one wave of them
_BLOCKS_PER_SM = {8: 2, 16: 2, QMM_WIDE: 1}
_SKINNY_TARGET_BLOCKS = 4 * _SMS
_SKINNY_THREADS, _SKINNY_COLS = 128, 4

_vp, _int = ctypes.c_void_p, ctypes.c_int
QUANTIZED_MATMUL = CudaKernel(
    "quantized_matmul", "quantized_matmul.cu", "quantized_matmul",
    [_vp, _vp, _vp, _vp, _vp, _vp,            # x, q, scales, bias, out, work
     _int, _int, _int, _int, _int,            # m, k, n, group, bits
     _int, _int, _int, _int, _vp])            # tile_m, chunk, dtype, out_f32, stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How the kernel covers one product: ``tile_m`` rows of x a block (wgmma's
    N: 8, 16 or ``QMM_WIDE``; 0 on the f32 path, whose regime follows m),
    ``chunk`` payload rows a k-split walks (0: no split) and ``splits``."""
    tile_m: int
    chunk: int
    splits: int


@functools.lru_cache(maxsize=1024)
def qmm_plan(m: int, k: int, n: int, group: int, bits: int, dtype: torch.dtype) -> QmmPlan:
    """The kernel's tiling and split-k for ``x (m, k) @ W (k, n)`` quantized in
    groups of ``group`` rows. bf16/fp16: the smallest tile of ``QMM_TILES``
    that holds m (m tiles of ``QMM_WIDE`` past 16 rows); where the column and
    m tiles leave SMs idle, the payload rows split across blocks so that one
    wave of ``_BLOCKS_PER_SM`` blocks an SM is full. A split walks whole
    stages, and whole groups where a group spans stages (int4: a group is
    g/2 byte rows, each holding both halves' rows). The f32 partials (splits
    x m x n, written and read back) stay within the payload's bytes. f32 x:
    the first version's skinny split (chunks of 8 rows) for m <= ``SKINNY_M``,
    else one tiled pass."""
    prow = k if bits == 8 else k // 2
    if dtype == torch.float32:
        if m > SKINNY_M:
            return QmmPlan(0, 0, 1)
        col_blocks = _cdiv(_cdiv(n, _SKINNY_COLS), _SKINNY_THREADS)
        splits = max(1, min(_cdiv(_SKINNY_TARGET_BLOCKS, col_blocks), prow // (8 * m),
                            _cdiv(prow, 32)))
        chunk = _cdiv(_cdiv(prow, splits), 8) * 8
        return QmmPlan(0, chunk, _cdiv(prow, chunk))
    tile = next(t for t in QMM_TILES if m <= t or t == QMM_WIDE)
    return qmm_split(m, k, n, group, bits, tile)


def qmm_split(m: int, k: int, n: int, group: int, bits: int, tile: int) -> QmmPlan:
    """The split-k of :func:`qmm_plan` for a given bf16/fp16 ``tile`` (one of
    ``QMM_TILES``; any tile covers any m in m tiles)."""
    prow = k if bits == 8 else k // 2
    stage = QMM_STAGE_ROWS[bits]
    group_rows = group if bits == 8 else group // 2
    unit = group_rows if group_rows % stage == 0 else stage
    blocks = _cdiv(m, tile) * _cdiv(n, QMM_BLOCK_COLS)
    splits = max(1, min(_SMS * _BLOCKS_PER_SM[tile] // blocks, _cdiv(prow, unit),
                        prow // (8 * m)))
    if splits == 1:
        return QmmPlan(tile, 0, 1)
    chunk = _cdiv(_cdiv(prow, unit), splits) * unit
    return QmmPlan(tile, chunk, _cdiv(prow, chunk))


def _check(x, q, scales, bits, bias):
    if bits != 8 and bits != 4:
        raise ValueError(f"quantized_matmul: bits={bits} not in (8, 4)")
    if x.dim() != 2 or q.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"need x (m, k), q 2-D and scales (k/g, n), got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")
    k = x.shape[1]
    groups, n = scales.shape
    if groups < 1 or k % groups:
        raise ValueError(f"scales {tuple(scales.shape)}: {groups} groups do not divide k={k}")
    rows = k if bits == 8 else k // 2
    if q.shape[0] != rows or q.shape[1] != n or (bits == 4 and (k // groups) % 2):
        raise ValueError(f"int{bits} payload for x {tuple(x.shape)} and {groups} groups must "
                         f"be ({rows}, {n})" + (" with an even group" if bits == 4 else "")
                         + f", got {tuple(q.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"need an int8 payload and f32 scales, got {q.dtype}, {scales.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be one of {list(DTYPE_CODES)}, got {x.dtype}")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != n):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *, bits: int = 8,
                     out_dtype: Optional[torch.dtype] = None,
                     _bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (m, k) @ dequant(q, scales) → (m, n)`` in ``out_dtype`` (default x's).

    ``q``: int8 ``(k, n)`` (bits 8) or packed ``(k//2, n)`` (bits 4);
    ``scales``: f32 ``(k//g, n)``. f32 accumulation, w rounded to x's dtype.
    ``_bias`` (internal, for :func:`quant_dense_apply`): ``(n,)``, added as
    ``y.to(out_dtype) + _bias.to(out_dtype)``, in the kernel's epilogue."""
    _check(x, q, scales, bits, _bias)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scales, bits=bits, out_dtype=out_dtype, _bias=_bias)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cuda or cpu tensors, not {x.device}")
    if q.device != x.device or scales.device != x.device or \
            (_bias is not None and _bias.device != x.device):
        raise ValueError("x, q, scales and the bias must be on one device")
    m, k = x.shape
    groups, n = scales.shape
    # the kernel writes x's dtype or f32 (with the bias); any other dtype is
    # the f32 result cast, and the bias added, here
    native = out_dtype in (x.dtype, torch.float32)
    out = torch.empty(m, n, dtype=out_dtype if native else torch.float32, device=x.device)
    if m == 0:
        return out.to(out_dtype)
    x = x.contiguous()
    q = q.contiguous()
    scales = scales.contiguous()
    bias = _bias.to(torch.float32).contiguous() if native and _bias is not None else None
    plan = qmm_plan(m, k, n, k // groups, bits, x.dtype)
    work = torch.empty(plan.splits, m, n, dtype=torch.float32, device=x.device) \
        if plan.splits > 1 else out
    QUANTIZED_MATMUL.launch(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), work.data_ptr(), m, k, n, k // groups, bits, plan.tile_m, plan.chunk,
        DTYPE_CODES[x.dtype], int(out.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    if native:
        return out
    out = out.to(out_dtype)
    return out if _bias is None else out + _bias.to(out_dtype)


def dequantize_to(q: torch.Tensor, scales: torch.Tensor, bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The weight ``(k, n)`` the kernel multiplies by: dequantized in f32,
    rounded to ``dtype``."""
    if bits == 4:
        q = unpack_int4(q, scales.shape[-2])
    return dequantize_grouped(q, scales).to(dtype)


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
                           bits: int = 8, out_dtype: Optional[torch.dtype] = None,
                           _bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain tensor code, as ``_qmm_kernel``: w
    dequantized in f32 and rounded to x's dtype, then an f32 product, cast to
    ``out_dtype``; ``_bias`` cast to ``out_dtype`` and added there."""
    out_dtype = out_dtype or x.dtype
    w = dequantize_to(q, scales, bits, x.dtype)
    y = (x.float() @ w.float()).to(out_dtype)
    return y if _bias is None else y + _bias.to(out_dtype)


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
    to ``dtype`` and added there (on the card, in the kernel's epilogue: one
    launch a projection)."""
    bits = node_bits(node)
    q, s = node_qs(node)
    lead = x.shape[:-1]
    return quantized_matmul(x.to(dtype).reshape(-1, x.shape[-1]), q, s, bits=bits,
                            out_dtype=dtype, _bias=bias).reshape(*lead, q.shape[-1])
