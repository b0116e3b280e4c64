"""Decode attention against a head-major KV cache: the hand-written Hopper
kernel ``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/attention/decode.py`` (``decode_attention``
/ ``_decode_kernel``, plain ``decode_attention_xla``). The cache is
``(b, h_kv, T, d)`` with ``T`` the capacity; ``cache_len`` counts each
sequence's valid rows, the current position included. Grouped-query attention
(``h_kv`` dividing ``h``) shares one pass over a group's rows. The JAX package
sent head_dim 64 to XLA on the TPU; this kernel takes 64 and 128.
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from ..op_builder import CudaKernel
from .flash import DTYPE_CODES, HEAD_DIMS, NEG_INF

_vp, _int = ctypes.c_void_p, ctypes.c_int
DECODE_ATTENTION = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention",
    [_vp, _vp, _vp, _vp, _vp,                 # q, k_cache, v_cache, lens, out
     _int, _int, _int, _int, _int,            # b, h_kv, g, T, d
     ctypes.c_float, _int, _vp])              # scale, dtype, stream


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
    ``[0, cache_len[i])`` of sequence ``i`` → ``(b, h, d)`` in q's dtype."""
    _check(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    hk, cap = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q and caches must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if cache_len.dtype != torch.int32 or cache_len.device != q.device:
        raise TypeError("cache_len must be an int32 tensor on q's device")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and cache_len.is_contiguous()):
        raise ValueError("decode_attention kernel takes contiguous q, caches and cache_len")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel takes 16-byte-aligned caches")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DECODE_ATTENTION.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                            cache_len.data_ptr(), out.data_ptr(), b, hk, h // hk, cap, d,
                            scale, DTYPE_CODES[q.dtype], stream)
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
