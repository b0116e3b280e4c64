"""Paged decode attention: the hand-written Hopper kernel
``csrc/paged_decode_attention.cu``, its plain PyTorch version, and the page
movers the serving column shares.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py``. The KV store is one
global pool of fixed-size pages per layer, ``{"k": (P, h_kv, page, d), "v":
...}``; each slot owns a page-table row ``(max_pages,)`` of physical page
indices, padded with the null page 0, which is never allocated and which no
live slot reads. :func:`paged_attention` launches the kernel for CUDA tensors
and runs :func:`paged_attention_plain` (the dense gather, then the slot-row
decode math, as ``paged_attention_xla``) for CPU tensors only. The JAX
package's ``fused_paged_for`` and ``DS_TPU_PAGED_FORCE_FUSED`` have no
counterpart: on the card the kernel always runs, splitting each (slot, kv
head) over the :func:`paged_split` blocks of a thread-block cluster.
"""

import ctypes

import numpy as np
import torch

from .attention.decode import UNIT_ROWS, cluster_split, decode_attention_plain
from .attention.flash import DTYPE_CODES, HEAD_DIMS
from .op_builder import CudaKernel

NULL_PAGE = 0

_vp, _int = ctypes.c_void_p, ctypes.c_int
PAGED_DECODE_ATTENTION = CudaKernel(
    "paged_decode_attention", "paged_decode_attention.cu", "paged_decode_attention",
    [_vp, _vp, _vp, _vp, _vp, _vp,            # q, k_pages, v_pages, table, lens, out
     _int, _int, _int, _int, _int, _int,      # b, h_kv, g, page, max_pages, d
     ctypes.c_float, _int, _int, _vp])        # scale, splits, dtype, stream


def paged_split(b: int, hk: int, max_pages: int, page: int, d: int, g: int,
                itemsize: int) -> int:
    """The blocks of a cluster that split one (slot, kv head)'s live pages in
    the kernel: the dense kernel's rule (:func:`cluster_split`, shapes only)
    over ``b * hk`` pairs of at most ``max_pages`` pages of ``page`` rows,
    each ``cdiv(page, 64)`` units."""
    return cluster_split(b * hk, max_pages * -(-page // UNIT_ROWS), max_pages * page, d, g,
                         itemsize)


def gather_kv_dense(k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor,
                    cap: int):
    """The dense head-major view ``(b, h_kv, cap, d)`` × 2 of each slot's pages:
    rows past the table's ``max_pages * page`` do not exist, rows past ``cap``
    are sliced off, so the view has the slot-row pool's exact shape."""
    idx = page_table.long()
    kp, vp = k_pages[idx], v_pages[idx]             # (b, mp, hk, page, d)
    b, mp, hk, ps, d = kp.shape
    k = kp.permute(0, 2, 1, 3, 4).reshape(b, hk, mp * ps, d)
    v = vp.permute(0, 2, 1, 3, 4).reshape(b, hk, mp * ps, d)
    return k[:, :, :cap], v[:, :, :cap]


def page_rows(page_table: torch.Tensor, rows: torch.Tensor, page: int, valid: torch.Tensor):
    """``(physical page, offset)`` of row ``rows[i]`` of slot ``i``, for a write.

    Out-of-range indices: JAX clamps an out-of-range gather and drops an
    out-of-range scatter; here the same index raises a device-side assert or
    writes out of bounds. So the table column is clamped into the table, and
    every row that is not ``valid`` (or past the table) is routed to the null
    page 0: a write never lands on a page the slot does not own. Several such
    rows may then write page 0 at once, and duplicate indices in one index
    write race each other; that race is harmless, because no live slot reads
    page 0: the kernel reads only a slot's own live pages, and the plain
    version masks every row at or past ``cache_len`` before its product with
    V. A dead slot (released, its table row all null pages) reads it, and its
    output is discarded."""
    mp = page_table.shape[1]
    rows = rows.long()
    col = torch.div(rows, page, rounding_mode="floor")
    inside = valid & (col < mp) & (rows >= 0)
    pidx = page_table.long().gather(1, col.clamp(0, mp - 1)[:, None])[:, 0]
    return torch.where(inside, pidx, torch.full_like(pidx, NULL_PAGE)), rows % page


def paged_cache_update(k_pages: torch.Tensor, v_pages: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, page_table: torch.Tensor,
                       cache_len: torch.Tensor) -> None:
    """In place: append one decode step's K/V ``(b, h_kv, 1, d)`` at each slot's
    row ``cache_len``, i.e. physical page ``table[s, cache_len[s] // page]``, row
    ``cache_len[s] % page`` (see :func:`page_rows` for rows past the table).
    The allocator gives slots disjoint private pages past any shared prefix,
    so live slots never write the same row."""
    ps = k_pages.shape[2]
    pidx, off = page_rows(page_table, cache_len, ps, torch.ones_like(cache_len, dtype=torch.bool))
    k_pages[pidx, :, off] = k_new[:, :, 0].to(k_pages.dtype)
    v_pages[pidx, :, off] = v_new[:, :, 0].to(v_pages.dtype)


def _check(q, k_pages, v_pages, page_table, cache_len):
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"need q (b, h, d) and k/v pages (P, h_kv, page, d), got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, d = q.shape
    if k_pages.shape[3] != d or h % k_pages.shape[1]:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != b or tuple(cache_len.shape) != (b,):
        raise ValueError(f"need page_table ({b}, max_pages) and cache_len ({b},), got "
                         f"{tuple(page_table.shape)}, {tuple(cache_len.shape)}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, cache_len: torch.Tensor, cap: int,
                    softmax_scale=None) -> torch.Tensor:
    """One decode step of paged attention: q ``(b, h, d)`` over rows
    ``[0, cache_len[i])`` of slot ``i`` → ``(b, h, d)`` in q's dtype. ``cap`` is
    the slot capacity of the dense view the plain version gathers; the kernel
    reads the table and ``cache_len`` from device memory and needs no view;
    it splits each (slot, kv head) over :func:`paged_split` blocks."""
    _check(q, k_pages, v_pages, page_table, cache_len)
    b, h, d = q.shape
    hk, ps = k_pages.shape[1], k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, cache_len, cap, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, not {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q and pages must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name, x in (("page_table", page_table), ("cache_len", cache_len)):
        if x.dtype != torch.int32 or x.device != q.device or not x.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor on q's device")
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention kernel takes contiguous q and pages")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel takes 16-byte-aligned pages")
    out = torch.empty_like(q)
    PAGED_DECODE_ATTENTION.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), b, hk, h // hk, ps, page_table.shape[1], d,
        scale, paged_split(b, hk, page_table.shape[1], ps, d, h // hk, q.element_size()),
        DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor, cache_len: torch.Tensor, cap: int,
                          scale: float) -> torch.Tensor:
    """The kernel's function in plain tensor code, as ``paged_attention_xla``:
    gather the dense ``cap``-row view, then the slot-row decode math in f32."""
    k, v = gather_kv_dense(k_pages, v_pages, page_table, cap)
    return decode_attention_plain(q, k, v, cache_len, scale)
