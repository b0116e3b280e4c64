"""Decode attention against a head-major KV cache: the hand-written Hopper
kernel ``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/attention/decode.py`` (``decode_attention``
/ ``_decode_kernel``, plain ``decode_attention_xla``). The cache is
``(b, h_kv, T, d)`` with ``T`` the capacity; ``cache_len`` counts each
sequence's valid rows, the current position included. Grouped-query attention
(``h_kv`` dividing ``h``) shares one pass over a group's rows. The JAX package
sent a head_dim that is not a multiple of 128 to XLA on the TPU; this kernel
takes any multiple of 8 up to 256 (``flash.kernel_width``), on a build 64, 128
or 256 wide with the real head_dim passed at run time.

The kernel splits each (sequence, kv head) over the :func:`decode_split`
blocks of a thread-block cluster; :func:`cluster_split` is the rule it shares
with the paged decode kernel, whose body (``csrc/decode_split.cuh``) it runs.
"""

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..op_builder import CudaKernel
from .flash import DTYPE_CODES, NEG_INF, kernel_width

_vp, _int = ctypes.c_void_p, ctypes.c_int
DECODE_ATTENTION = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention",
    [_vp, _vp, _vp, _vp, _vp,                 # q, k_cache, v_cache, lens, out
     _int, _int, _int, _int, _int,            # b, h_kv, g, T, d
     ctypes.c_float, _int, _int, _vp])        # scale, splits, dtype, stream

#: the split kernels' cluster sizes: the blocks that share one (sequence or
#: slot, kv head)
SPLITS = (1, 2, 4, 8)
#: rows of a unit of the split body (a dense tile, at most a page's piece)
UNIT_ROWS = 64
#: an H100 SXM's SMs, and what one SM gives its resident blocks: shared
#: memory (of which it keeps 1 KB a block) and 32-bit registers (allocated
#: in steps of 8 a thread)
H100_SMS = 132
SM_SMEM_BYTES = 233472
BLOCK_SMEM_RESERVED = 1024
SM_REGISTERS = 65536
#: the most shared memory a block may ask for
BLOCK_SMEM_MAX = 232448
#: registers a thread of the split body, by (element bytes, build width, G):
#: the larger of ``dense_decode_split``'s and ``paged_decode_split``'s, as
#: ``nvcc -Xptxas -v`` reports them for sm_90a (CUDA 12.8), for a head_dim
#: equal to the width (its strides constant) and below it (taken at run
#: time). A four-head block (288 threads) of more than 112 holds an SM's
#: registers alone; of 112 or fewer (16-bit at d 64, f32 at d 64 and 128
#: and below 128) two fit. A block of two heads or one (160 threads) of up
#: to 136 leaves room for three.
SPLIT_REGISTERS = {
    (2, 64, 1): (77, 80), (2, 64, 2): (80, 91), (2, 64, 4): (110, 124),
    (2, 128, 1): (77, 80), (2, 128, 2): (93, 92), (2, 128, 4): (126, 128),
    (2, 256, 1): (75, 81), (2, 256, 2): (80, 89), (2, 256, 4): (124, 128),
    (4, 64, 1): (75, 80), (4, 64, 2): (79, 93), (4, 64, 4): (95, 121),
    (4, 128, 1): (77, 80), (4, 128, 2): (77, 80), (4, 128, 4): (95, 95),
    (4, 256, 1): (94, 82), (4, 256, 2): (92, 80), (4, 256, 4): (127, 127),
}
#: a split that fills more than this share of the resident blocks pays a
#: fixed cost that grows with S (the cluster's launch and merge: 0.0080 →
#: 0.0103 ms from S 4 to 8 at K2's main path, 0.0089 → 0.0122 at Qwen2-7B's
#: shape; ``benchmarks/torch/paged_parts.py decode_attention``), which only
#: a walk of at least FULL_CARD_ROWS rows a block repays
FULL_CARD_SHARE = 0.75
FULL_CARD_ROWS = 256


def heads_a_block(g: int) -> int:
    """G, the query heads of a kv group a block of the split body takes: the
    least of 1, 2, 4 that covers ``g`` (above 4, ``cdiv(g, 4)`` head blocks)."""
    return 1 if g <= 1 else 2 if g <= 2 else 4


def split_smem_bytes(itemsize: int, d: int, heads: int) -> int:
    """``decode_split::smem_bytes<T, D, G>()`` at the build width D that runs
    head_dim ``d``, with the key window (the paged kernel's; the dense
    kernel's is that less ``4 * stages * 64`` bytes, which changes no count of
    blocks an SM). The ring has 4 stages where one holds at most 16 KB, else
    3, and fewer where they would not fit a block's shared memory beside the
    partials (2 at D 256 in 16-bit with four heads, 1 in f32)."""
    width = kernel_width(d, training=False)
    stage = 2 * UNIT_ROWS * width * itemsize
    fixed = 4 * ((8 if heads >= 4 else 4) + 1) * heads * (width + 2)
    stages = 4 if stage <= 16384 else 3
    while stages > 1 and stages * (stage + 4 * UNIT_ROWS + 16) + fixed > BLOCK_SMEM_MAX:
        stages -= 1
    return stages * (stage + 4 * UNIT_ROWS + 16) + fixed


def resident_blocks(itemsize: int, d: int, heads: int) -> int:
    """The split body's blocks of one instantiation the card holds at once:
    132 SMs times the fewer of what an SM's shared memory and its registers
    hold."""
    threads = 32 * ((8 if heads >= 4 else 4) + 1)
    width = kernel_width(d, training=False)
    exact, below = SPLIT_REGISTERS[(itemsize, width, heads)]
    regs = -(-(exact if d == width else below) // 8) * 8
    by_smem = SM_SMEM_BYTES // (split_smem_bytes(itemsize, d, heads) + BLOCK_SMEM_RESERVED)
    return H100_SMS * min(by_smem, SM_REGISTERS // (regs * threads))


@functools.lru_cache(maxsize=256)
def cluster_split(pairs: int, units: int, rows: int, d: int, g: int, itemsize: int) -> int:
    """The blocks S of a cluster that split one (sequence, kv head) in the
    dense and paged decode kernels, from shapes alone: ``cache_len`` lives
    on the device, and reading it would cost a host sync (and a CUDA graph
    could not replay the choice). The largest of :data:`SPLITS` whose
    ``pairs * cdiv(g, G) * S`` blocks the card holds at once
    (:func:`resident_blocks`), no more than ``units``, the most units a pair
    can have, and, where those blocks fill more than
    :data:`FULL_CARD_SHARE` of the card, no more than ``rows`` (the most
    rows a pair can have) over :data:`FULL_CARD_ROWS`. So S grows as the
    pairs fall. A split of a short sequence walks nothing and costs little,
    while a block that waits for a second wave costs a whole walk
    (``benchmarks/torch/qmm_versions.py``, ``[split]`` lines)."""
    heads = heads_a_block(g)
    blocks = pairs * -(-g // heads)
    resident = resident_blocks(itemsize, d, heads)
    s = SPLITS[0]
    for nxt in SPLITS[1:]:
        full = blocks * nxt > FULL_CARD_SHARE * resident
        if blocks * nxt > resident or nxt > units or (full and rows < FULL_CARD_ROWS * nxt):
            break
        s = nxt
    return s


def decode_split(b: int, hk: int, g: int, cap: int, d: int, itemsize: int) -> int:
    """:func:`cluster_split` for the dense kernel: ``b * hk`` pairs of at
    most ``cap`` rows in ``cdiv(cap, 64)`` tiles."""
    return cluster_split(b * hk, -(-cap // UNIT_ROWS), cap, d, g, itemsize)


def _check(q, k_cache, v_cache, cache_len):
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (b, h, d) and k/v caches (b, h_kv, T, d), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if h % k_cache.shape[1]:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {k_cache.shape[1]}")
    if tuple(cache_len.shape) != (b,):
        raise ValueError(f"cache_len must be ({b},), got {tuple(cache_len.shape)}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One decode step: q ``(b, h, d)`` against the caches, rows
    ``[0, cache_len[i])`` of sequence ``i`` → ``(b, h, d)`` in q's dtype. A
    sequence with ``cache_len`` 0 gets zeros from the kernel (the TPU kernel's
    ``l_safe``), the mean of its masked rows from the plain version."""
    _check(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    hk, cap = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    kernel_width(d, training=False)
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q and caches must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if cache_len.dtype != torch.int32 or cache_len.device != q.device:
        raise TypeError("cache_len must be an int32 tensor on q's device")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and cache_len.is_contiguous()):
        raise ValueError("decode_attention kernel takes contiguous q, caches and cache_len")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel takes 16-byte-aligned q and caches")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DECODE_ATTENTION.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                            cache_len.data_ptr(), out.data_ptr(), b, hk, h // hk, cap, d,
                            scale, decode_split(b, hk, h // hk, cap, d, q.element_size()),
                            DTYPE_CODES[q.dtype], stream)
    return out


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_len: torch.Tensor, scale: float) -> torch.Tensor:
    """The same function as the kernel in plain tensor code, all in f32."""
    b, h, d = q.shape
    hk, cap = k_cache.shape[1], k_cache.shape[2]
    q4 = q.reshape(b, hk, h // hk, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", q4, k_cache.float()) * scale
    valid = torch.arange(cap, device=q.device)[None, :] < cache_len.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)
