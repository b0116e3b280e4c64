"""Host Adam, Adagrad and f32 -> bf16 for the ZeRO-Offload tier.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (the reference's
``DeepSpeedCPUAdam``), on contiguous f32 CPU tensors: the f32 masters and the
optimizer state live in host memory, and each step is one fused in-place pass
a tensor through ``csrc/adam/cpu_adam.cpp``, a copy of the JAX package's
source built the same way (``op_builder.load_host_op``), so the two packages'
host steps agree bit for bit.

Beside each function stands its plain PyTorch version (``*_plain``), the same
formula written as tensor code, as the JAX package's numpy fallback writes it.
The tests hold the C++ ops to them; the offload tier never calls them, and a
failed build raises instead of falling back.

The Adam step is FusedAdam's formula with ``denom = sqrt(v) * rsqrt(bc2) +
eps`` where ``ops/adam/fused_adam.py`` takes ``sqrt(v / bc2) + eps``: offloaded
training is close to in-device training, not equal to it.
"""

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from ..op_builder import load_host_op

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_host_op("adam/cpu_adam.cpp")
    f = ctypes.c_float
    lib.ds_adam_step.argtypes = [_P, _P, _P, _P, ctypes.c_int64, f, f, f, f, f,
                                 ctypes.c_int, f, f]
    lib.ds_adam_step.restype = None
    lib.ds_adagrad_step.argtypes = [_P, _P, _P, ctypes.c_int64, f, f, f]
    lib.ds_adagrad_step.restype = None
    lib.ds_fp32_to_bf16.argtypes = [_P, _P, ctypes.c_int64]
    lib.ds_fp32_to_bf16.restype = None
    return lib


def _flat_f32(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` itself, checked: a contiguous f32 CPU tensor (the C op writes
    through its pointer, so a copy would lose the update)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" \
            or t.dtype != torch.float32 or not t.is_contiguous():
        got = (f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"host optimizer {what} must be a contiguous f32 CPU tensor, "
                         f"got {got}")
    return t


def _same_size(n: int, **tensors) -> None:
    for name, t in tensors.items():
        if t.numel() != n:
            raise ValueError(f"host optimizer: {name} has {t.numel()} elements, the "
                             f"parameter {n}")


def _bias_corrections(beta1: float, beta2: float, step: int,
                      bias_correction: bool) -> Tuple[float, float]:
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 - beta1 ** step, 1.0 - beta2 ** step


def adam_step(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              lr: float, beta1: float, beta2: float, eps: float, weight_decay: float,
              adam_w_mode: bool, step: int, bias_correction: bool = True) -> None:
    """One fused Adam step in place on f32 CPU tensors ``p``, ``m``, ``v``
    from the gradient ``g``; ``step`` counts from 1."""
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        _flat_f32(t, name)
    _same_size(p.numel(), m=m, v=v, g=g)
    bc1, bc2 = _bias_corrections(beta1, beta2, step, bias_correction)
    _lib().ds_adam_step(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                        p.numel(), lr, beta1, beta2, eps, weight_decay, int(adam_w_mode),
                        bc1, bc2)


@torch.no_grad()
def adam_step_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    lr: float, beta1: float, beta2: float, eps: float, weight_decay: float,
                    adam_w_mode: bool, step: int, bias_correction: bool = True) -> None:
    """:func:`adam_step` as tensor code, in f32, in the C op's order (its
    constants, too, are f32: ``1 - beta2`` in f32 is not ``1 - beta2`` in
    f64 rounded)."""
    bc1, bc2 = _bias_corrections(beta1, beta2, step, bias_correction)
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    b1, b2, one = f32(beta1), f32(beta2), f32(1.0)
    inv_bc1 = one / f32(bc1)
    inv_sqrt_bc2 = one / torch.sqrt(f32(bc2))
    grad = g.float()
    if weight_decay != 0.0 and not adam_w_mode:
        grad = grad + f32(weight_decay) * p
    m.copy_(b1 * m + (one - b1) * grad)
    v.copy_(b2 * v + (one - b2) * grad * grad)
    denom = torch.sqrt(v) * inv_sqrt_bc2 + f32(eps)
    delta = (m * inv_bc1) / denom
    if weight_decay != 0.0 and adam_w_mode:
        delta = delta + f32(weight_decay) * p
    p.sub_(f32(lr) * delta)


def adagrad_step(p: torch.Tensor, s: torch.Tensor, g: torch.Tensor, lr: float, eps: float,
                 weight_decay: float) -> None:
    """One fused Adagrad step in place on f32 CPU tensors (the squared-gradient
    sum ``s``)."""
    for name, t in (("p", p), ("sum_sq", s), ("g", g)):
        _flat_f32(t, name)
    _same_size(p.numel(), sum_sq=s, g=g)
    _lib().ds_adagrad_step(p.data_ptr(), s.data_ptr(), g.data_ptr(), p.numel(), lr, eps,
                           weight_decay)


@torch.no_grad()
def adagrad_step_plain(p: torch.Tensor, s: torch.Tensor, g: torch.Tensor, lr: float,
                       eps: float, weight_decay: float) -> None:
    """:func:`adagrad_step` as tensor code."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    grad = g.float() if weight_decay == 0.0 else g.float() + f32(weight_decay) * p
    s.add_(grad * grad)
    p.sub_(f32(lr) * grad / (torch.sqrt(s) + f32(eps)))


def as_f32(g: torch.Tensor, scratch: Optional[torch.Tensor]) -> torch.Tensor:
    """``g`` flat in f32 for the C ops: itself when it is f32, else its values
    in the front of ``scratch`` (an f32 buffer at least as long, reused leaf
    after leaf so a step allocates nothing)."""
    g = g.reshape(-1)
    if g.dtype == torch.float32:
        return g
    return scratch[:g.numel()].copy_(g)


def fp32_to_bf16(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round to nearest even, f32 -> bf16 (NaN stays a quiet NaN of its sign),
    in one threaded pass; into ``out`` (a contiguous bf16 CPU tensor of ``x``'s
    size, e.g. a pinned staging buffer) when given. Returns the bf16 tensor,
    shaped as ``x``."""
    _flat_f32(x, "f32 -> bf16 input")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.bfloat16)
    if out.dtype != torch.bfloat16 or out.device.type != "cpu" or not out.is_contiguous() \
            or out.numel() != x.numel():
        raise ValueError(f"fp32_to_bf16: out must be a contiguous bf16 CPU tensor of "
                         f"{x.numel()} elements, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    _lib().ds_fp32_to_bf16(x.data_ptr(), out.data_ptr(), x.numel())
    return out.view(x.shape)


def fp32_to_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`fp32_to_bf16` as PyTorch's cast (equal values; a NaN may carry
    another payload)."""
    return x.to(torch.bfloat16)


class DeepSpeedCPUAdam:
    """Host Adam over a list of flat f32 CPU tensors (reference
    ``DeepSpeedCPUAdam``). ``params`` are updated in place, so callers keep
    their references; ``m`` and ``v`` are allocated like them (pinned when
    they are)."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True):
        self.params = [_flat_f32(p, "parameter").view(-1) for p in params]
        self.m = [_zeros_like_host(p) for p in self.params]
        self.v = [_zeros_like_host(p) for p in self.params]
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.step_count = 0
        self._scratch: Optional[torch.Tensor] = None     # f32 copy of a 16-bit gradient

    def step(self, grads: List[torch.Tensor], lr: Optional[float] = None,
             on_leaf_done: Optional[Callable[[int], None]] = None) -> None:
        """One step over every leaf from ``grads`` (CPU tensors, f32 or a
        16-bit type, widened a leaf at a time); ``on_leaf_done(i)`` runs right
        after leaf ``i``'s update (the offload tier pushes that leaf to the
        device there, while the next leaf's update runs)."""
        if len(grads) != len(self.params):
            raise ValueError(f"DeepSpeedCPUAdam.step: {len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        self.step_count += 1
        lr = self.lr if lr is None else float(lr)
        if self._scratch is None and any(g.dtype != torch.float32 for g in grads):
            self._scratch = torch.empty(max(p.numel() for p in self.params))
        for i, (p, m, v, g) in enumerate(zip(self.params, self.m, self.v, grads)):
            adam_step(p, m, v, as_f32(g, self._scratch), lr, self.betas[0], self.betas[1], self.eps,
                      self.weight_decay, self.adamw_mode, self.step_count,
                      self.bias_correction)
            if on_leaf_done is not None:
                on_leaf_done(i)

    def state_dict(self) -> dict:
        return {"step": self.step_count, "m": self.m, "v": self.v}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.step_count = int(sd["step"])
        for dst, src in zip(self.m + self.v, list(sd["m"]) + list(sd["v"])):
            dst.copy_(src.reshape(-1))


def _zeros_like_host(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.numel(), dtype=torch.float32,
                       pin_memory=torch.cuda.is_available() and p.is_pinned())
