"""Kernel-vs-plain checks on the card: ONE source of shapes and tolerances.

Shared by ``chip_smoke.py`` and the card-only test
``tests/test_torch_kernels_cuda.py``, so the two cannot drift. Each case builds
seeded inputs on the card, calls the kernel's public wrapper and its plain
PyTorch version on the same inputs, and compares them in the working dtype.
The first case of each kernel is the shape its main path gives it: serving
(GPT-2 125M, batch 4, prompt 512) for the forward and decode kernels, training
(GPT-2 125M, micro-batch 24, seq 1024) for the two backward kernels.

Tolerances of the forward and decode kernels (max-abs-error of the output),
by input dtype:

- bfloat16 3e-2: the output is rounded to bf16 (half an ulp is up to 7.8e-3
  for |o| < 4), and the flash kernel rounds P to bf16 before normalising
  where the plain version rounds after, so one output can move by a few ulp.
  The JAX package's bf16 kernel checks use 3e-2 to 5e-2.
- float16 5e-3: the same two roundings with 3 more mantissa bits.
- float32 5e-5: everything is f32 in both; only the order of the sums and
  the exponential's implementation differ, a few ulp of values below 4.

Tolerances of the backward kernels are elementwise and relative to the plain
version: every element of dq, dk and dv must have |kernel - plain| <= atol +
rtol * |plain|. Most gradients at these shapes are of order 0.01-0.1, and
a few reach 4-5 (causal: early key columns collect many rows), so one
absolute limit would be either too tight for the largest or as large as a
typical value. The kernel and the plain version sum in different orders, and
ds is rounded to the input dtype before its products, where a different f32
sum can flip that rounding by an ulp. By input dtype:

- bfloat16 (2e-3, 1.6e-2): rtol is 2 bf16 ulps of the value (8 significant
  bits, one ulp is at most 2**-7 of it); atol covers values near 0, where a
  flipped ds rounding moves a sum by more than its own ulps.
- float16 (2.5e-4, 2e-3): the same two ulps and atol at fp16's 11 bits.
- float32 (2e-6, 2e-5): f32 sums of up to t = 1024 terms in other orders,
  with p = exp(s - lse) moving with s's last bits.

f32 matrix products of the plain versions run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``, set here).
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.causal_lm import alibi_slopes
from .attention.decode import decode_attention, decode_attention_plain
from .attention.flash import (flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
                             flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)

TOLERANCES = {torch.bfloat16: 3e-2, torch.float16: 5e-3, torch.float32: 5e-5}
#: (atol, rtol) of the backward kernels, by input dtype (see above)
BWD_TOLERANCES = {torch.bfloat16: (2e-3, 1.6e-2), torch.float16: (2.5e-4, 2e-3),
                  torch.float32: (2e-6, 2e-5)}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
LSE_TOLERANCE = 1e-3        # f32 logsumexp; sums of exp in another order

#: H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of device
#: memory, operations/s by input dtype (bf16/fp16 on the tensor cores, f32
#: outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

#: what each kernel replaces in the JAX package, and its source here
KERNEL_INFO = {
    "flash_fwd": {"source": "deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
                  "replaces": "deepspeed_tpu/ops/attention/flash.py:96"},
    "decode_attention": {"source": "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
                         "replaces": "deepspeed_tpu/ops/attention/decode.py:30"},
    "flash_bwd_dq": {"source": "deepspeed_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "replaces": "deepspeed_tpu/ops/attention/flash.py:205"},
    "flash_bwd_dkv": {"source": "deepspeed_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "replaces": "deepspeed_tpu/ops/attention/flash.py:257"},
}


@dataclasses.dataclass
class Case:
    kernel: str                  # "flash_fwd" | "decode_attention" | BWD_KERNELS
    name: str
    dims: Dict[str, int]         # flash (fwd and bwd): b, t, h, d; decode: b, h, hk, T, d
    dtype: torch.dtype
    causal: bool = True
    alibi: bool = False
    lens: Optional[Tuple[int, ...]] = None      # decode: valid rows per sequence
    main_path: bool = False


CASES: List[Case] = [
    Case("flash_fwd", "gpt2-prefill", dict(b=4, t=512, h=12, d=64), torch.bfloat16,
         main_path=True),
    # the training main path's forward: GPT-2 125M, micro-batch 24, seq 1024
    Case("flash_fwd", "gpt2-train", dict(b=24, t=1024, h=12, d=64), torch.bfloat16),
    Case("flash_fwd", "fp32", dict(b=2, t=1024, h=4, d=64), torch.float32),
    Case("flash_fwd", "alibi", dict(b=2, t=512, h=4, d=64), torch.bfloat16, alibi=True),
    Case("flash_fwd", "ragged-t500", dict(b=2, t=500, h=4, d=64), torch.bfloat16),
    Case("flash_fwd", "d128", dict(b=1, t=2048, h=32, d=128), torch.bfloat16),
    Case("flash_fwd", "fp16-full-d128", dict(b=2, t=300, h=4, d=128), torch.float16,
         causal=False),
    # lens: the midpoint of the main path's decode (prompts 512, 512, 512, 384)
    Case("decode_attention", "gpt2-decode", dict(b=4, h=12, hk=12, T=1024, d=64),
         torch.bfloat16, lens=(544, 544, 544, 416), main_path=True),
    Case("decode_attention", "gqa-d128", dict(b=4, h=16, hk=4, T=2048, d=128),
         torch.bfloat16, lens=(2048, 1337, 700, 101)),
    Case("decode_attention", "fp32-gqa-T300", dict(b=3, h=8, hk=2, T=300, d=64),
         torch.float32, lens=(300, 65, 1)),
] + [c for kernel in BWD_KERNELS for c in (
    # the training main path: GPT-2 125M, micro-batch 24, seq 1024
    Case(kernel, "gpt2-train", dict(b=24, t=1024, h=12, d=64), torch.bfloat16,
         main_path=True),
    Case(kernel, "d128", dict(b=2, t=1024, h=8, d=128), torch.bfloat16),
    Case(kernel, "ragged-t1000", dict(b=2, t=1000, h=4, d=64), torch.bfloat16),
    Case(kernel, "alibi", dict(b=2, t=512, h=4, d=64), torch.bfloat16, alibi=True),
    Case(kernel, "fp32", dict(b=2, t=1024, h=4, d=64), torch.float32),
    Case(kernel, "fp16-full-d128", dict(b=2, t=300, h=4, d=128), torch.float16,
         causal=False),
)]


def make_inputs(case: Case, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded inputs on ``device``. Decode caches hold 1e4 in the rows past each
    sequence's length, so a kernel that read them would show it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = case.dims

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(case.dtype)

    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        bh, t, d = dims["b"] * dims["h"], dims["t"], dims["d"]
        inp = {"q": randn(bh, t, d), "k": randn(bh, t, d), "v": randn(bh, t, d)}
        if case.alibi:
            inp["slopes"] = torch.from_numpy(alibi_slopes(dims["h"])).to(device)
        if case.kernel in BWD_KERNELS:
            # o and lse from the plain forward, so the backward's inputs do not
            # depend on the forward kernel
            inp["do"] = randn(bh, t, d)
            o, inp["lse"] = flash_fwd_plain(inp["q"], inp["k"], inp["v"], inp.get("slopes"),
                                            _scale(case), case.causal, dims["h"])
            inp["delta"] = (inp["do"].float() * o.float()).sum(-1)
        return inp
    b, h, hk, cap, d = dims["b"], dims["h"], dims["hk"], dims["T"], dims["d"]
    inp = {"q": randn(b, h, d), "k": randn(b, hk, cap, d), "v": randn(b, hk, cap, d),
           "lens": torch.tensor(case.lens, dtype=torch.int32, device=device)}
    for i, n in enumerate(case.lens):
        inp["k"][i, :, n:] = 1e4
        inp["v"][i, :, n:] = 1e4
    return inp


def _scale(case: Case) -> float:
    return 1.0 / float(np.sqrt(case.dims["d"]))


def _bwd_args(case: Case, inp):
    return (inp["q"], inp["k"], inp["v"], inp["do"], inp["lse"], inp["delta"],
            inp.get("slopes"), _scale(case), case.causal, case.dims["h"])


def run_kernel(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The kernel through its public wrapper: flash ``(o, lse)``, decode ``(o,)``,
    dq ``(dq,)``, dk/dv ``(dk, dv)``."""
    if case.kernel == "flash_bwd_dq":
        return (flash_bwd_dq(*_bwd_args(case, inp)),)
    if case.kernel == "flash_bwd_dkv":
        return flash_bwd_dkv(*_bwd_args(case, inp))
    if case.kernel == "flash_fwd":
        return flash_fwd(inp["q"], inp["k"], inp["v"], inp.get("slopes"), None, case.causal,
                         n_heads=case.dims["h"])
    return (decode_attention(inp["q"], inp["k"], inp["v"], inp["lens"]),)


def run_plain(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The plain version on the same inputs, same outputs as :func:`run_kernel`."""
    scale = _scale(case)
    if case.kernel == "flash_bwd_dq":
        return (flash_bwd_dq_plain(*_bwd_args(case, inp)),)
    if case.kernel == "flash_bwd_dkv":
        return flash_bwd_dkv_plain(*_bwd_args(case, inp))
    if case.kernel == "flash_fwd":
        return flash_fwd_plain(inp["q"], inp["k"], inp["v"], inp.get("slopes"), scale,
                               case.causal, case.dims["h"])
    return (decode_attention_plain(inp["q"], inp["k"], inp["v"], inp["lens"], scale),)


def library_fn(case: Case, inp) -> Optional[Callable[[], torch.Tensor]]:
    """One PyTorch call computing the same function, as a yardstick of speed
    only (never called by the package), or None where the installed torch
    has none. The backward kernels' yardstick is SDPA's whole backward (dq,
    dk and dv in one call), run on a graph built once outside the timing."""
    dims = case.dims
    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        b, t, h, d = dims["b"], dims["t"], dims["h"], dims["d"]
        q, k, v = (inp[n].view(b, h, t, d) for n in ("q", "k", "v"))
        kw = {"is_causal": case.causal}
        if case.alibi:
            rows = torch.arange(t, device=q.device)[:, None]
            cols = torch.arange(t, device=q.device)[None, :]
            bias = inp["slopes"][:, None, None] * (cols - rows).float()
            if case.causal:
                bias = bias.masked_fill(cols > rows, float("-inf"))
            kw = {"attn_mask": bias.to(q.dtype)}
        if case.kernel == "flash_fwd":
            return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, **kw)
        do = inp["do"].view(b, h, t, d)
        return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    b, h, hk, cap, d = dims["b"], dims["h"], dims["hk"], dims["T"], dims["d"]
    q = inp["q"].view(b, h, 1, d)
    mask = (torch.arange(cap, device=q.device)[None, :] < inp["lens"][:, None])[:, None, None]
    kw = {"enable_gqa": True} if h != hk else {}
    try:
        F.scaled_dot_product_attention(q, inp["k"], inp["v"], attn_mask=mask, **kw)
    except TypeError:            # a torch without enable_gqa
        return None
    return lambda: F.scaled_dot_product_attention(q, inp["k"], inp["v"], attn_mask=mask, **kw)


def work(case: Case) -> Tuple[float, float]:
    """(operations, bytes) the function needs on these inputs: each input read
    once, each output written once; decode counts only the valid cache rows,
    causal attention only the pairs with col <= row."""
    dims = case.dims
    es = torch.tensor([], dtype=case.dtype).element_size()
    d = dims["d"]
    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        bh, t = dims["b"] * dims["h"], dims["t"]
        pairs = t * (t + 1) // 2 if case.causal else t * t
        if case.kernel == "flash_bwd_dq":
            # recompute s, dp, dq: 6 d a pair; q, k, v, do in, dq out; f32 lse, delta
            return 6.0 * d * pairs * bh, 5.0 * bh * t * d * es + 8.0 * bh * t
        if case.kernel == "flash_bwd_dkv":
            # recompute s, dp, dv, dk: 8 d a pair; q, k, v, do in, dk, dv out
            return 8.0 * d * pairs * bh, 6.0 * bh * t * d * es + 8.0 * bh * t
        ops = 4.0 * d * pairs * bh
        nbytes = 4.0 * bh * t * d * es + 4.0 * bh * t          # q, k, v, o; f32 lse
        return ops, nbytes
    b, h, hk = dims["b"], dims["h"], dims["hk"]
    rows = float(sum(min(n, dims["T"]) for n in case.lens))
    ops = 4.0 * d * h * rows
    nbytes = 2.0 * b * h * d * es + 2.0 * hk * d * es * rows + 4.0 * b
    return ops, nbytes


def bound_ms(case: Case) -> Tuple[float, str]:
    """The least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for the input dtype."""
    ops, nbytes = work(case)
    t_ops = ops / PEAK_OPS_PER_S[case.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def err_ratio(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    """The largest ``|out - ref| / (atol + rtol * |ref|)`` over the elements: at
    most 1 where every element is within its limit."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs())).max())


def check(case: Case, device, seed: int = 0) -> Dict[str, float]:
    """Run one case; returns its errors and tolerance (``err_ratio`` <= 1 passes).
    Raises ``AssertionError`` if the kernel disagrees with its plain version or
    returns a non-finite value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = make_inputs(case, device, seed)
    out, ref = run_kernel(case, inp), run_plain(case, inp)
    if case.kernel in BWD_KERNELS:
        atol, rtol = BWD_TOLERANCES[case.dtype]
        pairs = list(zip(out, ref))
    else:
        atol, rtol = TOLERANCES[case.dtype], 0.0
        pairs = [(out[0], ref[0])]
    result = {"max_abs_err": max(max_abs_err(a, b) for a, b in pairs), "atol": atol,
              "rtol": rtol, "err_ratio": max(err_ratio(a, b, atol, rtol) for a, b in pairs)}
    if case.kernel == "flash_fwd":
        result["lse_err"] = max_abs_err(out[1], ref[1])
    name = f"{case.kernel}/{case.name}"
    if not all(bool(torch.isfinite(o.float()).all()) for o in out):
        raise AssertionError(f"{name}: non-finite output")
    if not result["err_ratio"] <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds {atol:g} + {rtol:g} |plain| "
                             f"by a factor {result['err_ratio']:.3g} (max abs err "
                             f"{result['max_abs_err']:.3e})")
    if not result.get("lse_err", 0.0) <= LSE_TOLERANCE:
        raise AssertionError(f"{name}: lse err {result['lse_err']:.3e} > {LSE_TOLERANCE}")
    return result


def run_kernel_checks(device) -> Dict[str, Dict[str, float]]:
    """Every case on ``device`` (a CUDA device); raises on the first failure."""
    return {f"{c.kernel}/{c.name}": check(c, device) for c in CASES}
