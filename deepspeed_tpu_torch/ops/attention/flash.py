"""Flash attention: the hand-written Hopper kernels ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``, their plain PyTorch
versions, and the autograd Function that joins them.

Counterpart of ``deepspeed_tpu/ops/attention/flash.py`` (``_flash_fwd`` /
``_fwd_kernel``, ``_flash_bwd`` / ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``, the
``_flash_core`` custom VJP, public ``flash_attention``). Each wrapper
(:func:`flash_fwd`, :func:`flash_bwd`) launches its kernels for CUDA tensors and
runs its plain version only for CPU tensors. The kernels mask a ragged last
tile themselves, so every ``t`` takes them.

The forward kernel writes through raw pointers, so its output has no autograd
history: under autograd the only way to it is :class:`FlashAttnFunction`, whose
backward runs the two backward kernels, and :func:`flash_fwd` refuses CUDA
inputs that require grad while grad mode is on.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..op_builder import CudaKernel

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the row widths the attention kernels are built for; a head_dim d runs on
#: the narrowest that holds it, with the real d passed at run time
KERNEL_WIDTHS = (64, 128, 256)
#: the widest head_dim the serving kernels (flash forward, dense and paged
#: decode) take, and the widest the training kernels (flash and block-sparse,
#: forward and backward) take
SERVE_MAX_HEAD_DIM = 256
TRAIN_MAX_HEAD_DIM = 128

_vp, _int = ctypes.c_void_p, ctypes.c_int
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu", "flash_fwd",
    [_vp, _vp, _vp, _vp, _vp, _vp,            # q, k, v, slopes, o, lse
     _int, _int, _int, _int,                  # bh, t, d, n_heads
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "flash_bwd_dq.cu", "flash_bwd_dq",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,  # q, k, v, do, lse, delta, slopes, dq
     _int, _int, _int, _int,                  # bh, t, d, n_heads
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "flash_bwd_dkv.cu", "flash_bwd_dkv",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp,       # q, k, v, do, lse, delta, slopes
     _vp, _vp,                                # dk, dv
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


def kernel_width(d: int, training: bool) -> int:
    """The row width of the attention kernels' build that runs head_dim ``d``:
    the narrowest of :data:`KERNEL_WIDTHS` that holds it. Raises ValueError
    for a ``d`` the card's kernels do not take: one that is not a multiple of
    8 (a row must be whole 16-byte pieces for the TMA and bulk copies), above
    :data:`SERVE_MAX_HEAD_DIM`, or above :data:`TRAIN_MAX_HEAD_DIM` where
    ``training`` (the backward kernels are built up to 128)."""
    limit = TRAIN_MAX_HEAD_DIM if training else SERVE_MAX_HEAD_DIM
    if d <= 0 or d % 8 or d > limit:
        mode = "training" if training else "serving"
        raise ValueError(f"head_dim {d} has no attention kernel on the card for {mode}: "
                         f"the kernels take a multiple of 8 up to {limit}")
    return next(w for w in KERNEL_WIDTHS if w >= d)


def _check_cuda(name: str, tensors, slopes, device, training: bool) -> None:
    """What the CUDA kernels take: a head_dim :func:`kernel_width` accepts,
    contiguous 16-byte-aligned tensors on one device, f32 slopes."""
    kernel_width(tensors[0].shape[-1], training)
    if not all(x.device == device and x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte-aligned inputs "
                         f"on one device")
    if slopes is not None:
        if slopes.dtype != torch.float32 or slopes.device != device \
                or not slopes.is_contiguous():
            raise ValueError("alibi slopes must be a contiguous f32 tensor on q's device")


def _scale(q3: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(q3.shape[-1]))


def flash_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              slopes: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None,
              causal: bool = True, n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """q3/k3/v3 ``(b*h, t, d)`` → ``(o (b*h, t, d) in q's dtype, lse (b*h, t) f32)``.

    ``slopes`` ``(n_heads,)``: ALiBi bias ``slopes[i % n_heads] * (col - row)``
    on row block ``i``, added before the mask. The kernel's output has no
    autograd history, so CUDA inputs that require grad are refused while grad
    mode is on: :class:`FlashAttnFunction` is the differentiable way in."""
    _check(q3, k3, v3, slopes, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, slopes, scale, causal, n_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q3.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q3, k3, v3)):
        raise ValueError("flash_fwd's kernel output carries no gradient: under autograd "
                         "call flash_attention (FlashAttnFunction) instead")
    _check_cuda("flash_fwd", (q3, k3, v3), slopes, q3.device, training=False)
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    FLASH_FWD.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                     None if slopes is None else slopes.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), bh, t, d, n_heads, scale,
                     int(causal), DTYPE_CODES[q3.dtype], stream)
    return o, lse


def _scores(q3, k3, slopes, scale, causal, n_heads):
    """f32 scores ``(b*h, t, t)`` as the kernels form them: scaled, ALiBi bias,
    then the -1e30 causal mask."""
    bh, t, _ = q3.shape
    s = torch.einsum("ntd,nsd->nts", q3.float(), k3.float()) * scale
    rows = torch.arange(t, device=q3.device)[:, None]
    cols = torch.arange(t, device=q3.device)[None, :]
    if slopes is not None:
        per_row = slopes.float().to(q3.device).repeat(bh // n_heads)
        s = s + per_row[:, None, None] * (cols - rows).float()
    if causal:
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def flash_fwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                    slopes: Optional[torch.Tensor], scale: float, causal: bool,
                    n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain tensor code: f32 scores, the
    ALiBi bias, the -1e30 causal mask, f32 softmax, probabilities cast to the
    input dtype before the product with v."""
    s = _scores(q3, k3, slopes, scale, causal, n_heads)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v3.dtype)
    o = torch.einsum("nts,nsd->ntd", p.float(), v3.float()).to(q3.dtype)
    return o, lse


def flash_bwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, o3: torch.Tensor,
              lse: torch.Tensor, do3: torch.Tensor, slopes: Optional[torch.Tensor] = None,
              softmax_scale: Optional[float] = None, causal: bool = True,
              n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of :func:`flash_fwd` for the output gradient
    ``do3``, each in its input's dtype, from the forward's ``o3`` and f32
    ``lse``. ``delta = rowsum(do * o)`` is formed here in f32, as the JAX
    package forms it outside its kernels; then :func:`flash_bwd_dq` and
    :func:`flash_bwd_dkv` each recompute the probabilities from ``lse``."""
    if o3.shape != q3.shape:
        raise ValueError(f"o must be {tuple(q3.shape)}, got {tuple(o3.shape)}")
    delta = (do3.float() * o3.float()).sum(-1)
    dq = flash_bwd_dq(q3, k3, v3, do3, lse, delta, slopes, softmax_scale, causal, n_heads)
    dk, dv = flash_bwd_dkv(q3, k3, v3, do3, lse, delta, slopes, softmax_scale, causal,
                           n_heads)
    return dq, dk, dv


def _check_bwd(name, q3, k3, v3, do3, lse, delta, slopes, n_heads) -> None:
    _check(q3, k3, v3, slopes, n_heads)
    rows = tuple(q3.shape[:2])
    if do3.shape != q3.shape or tuple(lse.shape) != rows or tuple(delta.shape) != rows:
        raise ValueError(f"{name}: do must be {tuple(q3.shape)}, lse and delta {rows}; got "
                         f"{tuple(do3.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}")
    if do3.dtype != q3.dtype or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: do must be {q3.dtype}, lse and delta float32; got "
                        f"{do3.dtype}, {lse.dtype}, {delta.dtype}")
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q3.device}")
    if q3.device.type == "cuda":
        _check_cuda(name, (q3, k3, v3, do3, lse, delta), slopes, q3.device, training=True)


def flash_bwd_dq(q3, k3, v3, do3, lse, delta, slopes=None, softmax_scale=None,
                 causal: bool = True, n_heads: int = 1) -> torch.Tensor:
    """dq in q's dtype: the kernel ``csrc/flash_bwd_dq.cu`` for CUDA tensors,
    :func:`flash_bwd_dq_plain` for CPU tensors. ``delta`` ``(b*h, t)`` f32 is
    ``rowsum(do * o)``."""
    _check_bwd("flash_bwd_dq", q3, k3, v3, do3, lse, delta, slopes, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
    bh, t, d = q3.shape
    dq = torch.empty_like(q3)
    FLASH_BWD_DQ.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(),
                        None if slopes is None else slopes.data_ptr(), dq.data_ptr(),
                        bh, t, d, n_heads, scale, int(causal), DTYPE_CODES[q3.dtype],
                        torch.cuda.current_stream(q3.device).cuda_stream)
    return dq


def flash_bwd_dkv(q3, k3, v3, do3, lse, delta, slopes=None, softmax_scale=None,
                  causal: bool = True, n_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in k's and v's dtype: the kernel ``csrc/flash_bwd_dkv.cu`` for
    CUDA tensors, :func:`flash_bwd_dkv_plain` for CPU tensors."""
    _check_bwd("flash_bwd_dkv", q3, k3, v3, do3, lse, delta, slopes, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal,
                                   n_heads)
    bh, t, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    FLASH_BWD_DKV.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(),
                         None if slopes is None else slopes.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), bh, t, d, n_heads, scale, int(causal),
                         DTYPE_CODES[q3.dtype], torch.cuda.current_stream(q3.device).cuda_stream)
    return dk, dv


def _probs_and_ds(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads):
    """The kernels' recompute: p = exp(s - lse) in f32, and ds = p (dp -
    delta) scale rounded to the input dtype (returned in f32)."""
    p = torch.exp(_scores(q3, k3, slopes, scale, causal, n_heads) - lse.float()[..., None])
    dp = torch.einsum("ntd,nsd->nts", do3.float(), v3.float())
    ds = (p * (dp - delta.float()[..., None]) * scale).to(q3.dtype).float()
    return p, ds


def flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads=1):
    """The dq kernel's function in plain tensor code: dq = ds k, f32 sums."""
    _, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
    return torch.einsum("nts,nsd->ntd", ds, k3.float()).to(q3.dtype)


def flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads=1):
    """The dk/dv kernel's function in plain tensor code: dk = ds^T q, dv =
    p^T do with p rounded to do's dtype first, f32 sums."""
    p, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
    dk = torch.einsum("nts,ntd->nsd", ds, q3.float()).to(k3.dtype)
    dv = torch.einsum("nts,ntd->nsd", p.to(do3.dtype).float(), do3.float()).to(v3.dtype)
    return dk, dv


def flash_bwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, o3: torch.Tensor,
                    lse: torch.Tensor, do3: torch.Tensor, slopes: Optional[torch.Tensor],
                    scale: float, causal: bool, n_heads: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_bwd` in plain tensor code, with the kernels' recompute
    formula and roundings (not autograd through :func:`flash_fwd_plain`):
    delta = rowsum(do * o) in f32, p = exp(s - lse), ds = p (dp - delta) scale
    rounded to the input dtype before the products with k and q, p rounded to
    do's dtype before the product with do."""
    delta = (do3.float() * o3.float()).sum(-1)
    dq = flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
    dk, dv = flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
    return dq, dk, dv


class FlashAttnFunction(torch.autograd.Function):
    """``o = attention(q3, k3, v3)`` through :func:`flash_fwd`, differentiated by
    :func:`flash_bwd`; the port of the ``_flash_core`` custom VJP. It saves q, k,
    v, o and the f32 lse. The ALiBi slopes are a fixed schedule and get no
    gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, slopes, softmax_scale, causal, n_heads):
        if q3.device.type == "cuda" and any(ctx.needs_input_grad[:3]):
            kernel_width(q3.shape[-1], training=True)   # before the forward launches
        o3, lse = flash_fwd(q3, k3, v3, slopes, softmax_scale, causal, n_heads)
        ctx.save_for_backward(q3, k3, v3, o3, lse, slopes)
        ctx.args = (softmax_scale, causal, n_heads)
        return o3

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o3, lse, slopes = ctx.saved_tensors
        softmax_scale, causal, n_heads = ctx.args
        dq, dk, dv = flash_bwd(q3, k3, v3, o3, lse, do3.contiguous(), slopes,
                               softmax_scale, causal, n_heads)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    mask: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_rng: Optional[int] = None,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention on ``(b, t, h, d)`` q/k/v → ``(b, t, h, d)``, through
    :class:`FlashAttnFunction`, so it is differentiable on the card as on the
    CPU. ``alibi_slopes`` ``(h,)`` adds the per-head ALiBi bias inside the
    kernels.

    The JAX function's rule for what its kernel does not cover (``flash.py:
    462-469``): a ``mask``, attention dropout (``dropout_rate > 0``, with the
    key ``dropout_rng``) or cross-attention (k longer or shorter than q) goes
    to ``reference_attention``, and no kernel launches; ALiBi together with any
    of them raises ``NotImplementedError``."""
    if mask is not None or dropout_rate > 0.0 or q.shape[1] != k.shape[1]:
        if alibi_slopes is not None:
            raise NotImplementedError(
                "alibi_slopes is kernel-only: combine it with mask/dropout/cross-attention "
                "through a model-level bias on the plain path instead")
        from ..transformer.attention import reference_attention
        return reference_attention(q, k, v, causal=causal, mask=mask,
                                   softmax_scale=softmax_scale, dropout_rate=dropout_rate,
                                   dropout_rng=dropout_rng)
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention is self-attention: q/k/v must share one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o3 = FlashAttnFunction.apply(to3(q), to3(k), to3(v), alibi_slopes, softmax_scale, causal,
                                 h)
    return o3.reshape(b, h, t, d).transpose(1, 2)
