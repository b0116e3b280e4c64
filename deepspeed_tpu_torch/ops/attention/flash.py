"""Flash-attention forward: the hand-written Hopper kernel ``csrc/flash_fwd.cu``
and its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/attention/flash.py`` (``_flash_fwd`` /
``_fwd_kernel``, public ``flash_attention``). Forward only: the backward
kernels are still to be ported. :func:`flash_fwd` launches the kernel for a
CUDA tensor and runs :func:`flash_fwd_plain` only for a CPU tensor. The kernel
masks a ragged last tile itself, so every ``t`` takes it.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..op_builder import CudaKernel

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128)

_vp, _int = ctypes.c_void_p, ctypes.c_int
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu", "flash_fwd",
    [_vp, _vp, _vp, _vp, _vp, _vp,            # q, k, v, slopes, o, lse
     _int, _int, _int, _int,                  # bh, t, d, n_heads
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream


def _check(q3, k3, v3, slopes, n_heads):
    if q3.ndim != 3 or q3.shape != k3.shape or q3.shape != v3.shape:
        raise ValueError(f"q/k/v must share one (b*h, t, d) shape, got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype) or q3.dtype not in DTYPE_CODES:
        raise TypeError(f"q/k/v must share one of {list(DTYPE_CODES)}, got "
                        f"{q3.dtype}, {k3.dtype}, {v3.dtype}")
    if q3.shape[0] % n_heads:
        raise ValueError(f"b*h={q3.shape[0]} is not a multiple of n_heads={n_heads}")
    if slopes is not None and tuple(slopes.shape) != (n_heads,):
        raise ValueError(f"alibi slopes must be ({n_heads},), got {tuple(slopes.shape)}")


def flash_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              slopes: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None,
              causal: bool = True, n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """q3/k3/v3 ``(b*h, t, d)`` → ``(o (b*h, t, d) in q's dtype, lse (b*h, t) f32)``.

    ``slopes`` ``(n_heads,)``: ALiBi bias ``slopes[i % n_heads] * (col - row)``
    on row block ``i``, added before the mask."""
    _check(q3, k3, v3, slopes, n_heads)
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(q3.shape[-1]))
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, slopes, scale, causal, n_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q3.device}")
    bh, t, d = q3.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q3, k3, v3)):
        raise ValueError("flash_fwd kernel takes contiguous, 16-byte-aligned q/k/v")
    if slopes is not None:
        if slopes.dtype != torch.float32 or slopes.device != q3.device \
                or not slopes.is_contiguous():
            raise ValueError("alibi slopes must be a contiguous f32 tensor on q's device")
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    FLASH_FWD.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                     None if slopes is None else slopes.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), bh, t, d, n_heads, scale,
                     int(causal), DTYPE_CODES[q3.dtype], stream)
    return o, lse


def flash_fwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                    slopes: Optional[torch.Tensor], scale: float, causal: bool,
                    n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain tensor code: f32 scores, the
    ALiBi bias, the -1e30 causal mask, f32 softmax, probabilities cast to the
    input dtype before the product with v."""
    bh, t, _ = q3.shape
    s = torch.einsum("ntd,nsd->nts", q3.float(), k3.float()) * scale
    rows = torch.arange(t, device=q3.device)[:, None]
    cols = torch.arange(t, device=q3.device)[None, :]
    if slopes is not None:
        per_row = slopes.float().to(q3.device).repeat(bh // n_heads)
        s = s + per_row[:, None, None] * (cols - rows).float()
    if causal:
        s = s.masked_fill(cols > rows, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v3.dtype)
    o = torch.einsum("nts,nsd->ntd", p.float(), v3.float()).to(q3.dtype)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention on ``(b, t, h, d)`` q/k/v → ``(b, t, h, d)``, through
    :func:`flash_fwd`. ``alibi_slopes`` ``(h,)`` adds the per-head ALiBi bias
    inside the kernel."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention is self-attention: q/k/v must share one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    o3, _ = flash_fwd(to3(q), to3(k), to3(v), alibi_slopes, softmax_scale, causal, n_heads=h)
    return o3.reshape(b, h, t, d).transpose(1, 2)
