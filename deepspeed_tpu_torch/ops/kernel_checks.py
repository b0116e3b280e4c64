"""Kernel-vs-plain checks on the card: ONE source of shapes and tolerances.

Shared by ``chip_smoke.py`` and the card-only test
``tests/test_torch_kernels_cuda.py``, so the two cannot drift. Each case builds
seeded inputs on the card, calls the kernel's public wrapper and its plain
PyTorch version on the same inputs, and compares them in the working dtype.
The first case of each kernel is the shape the serving main path gives it
(GPT-2 125M, batch 4, prompt 512).

Tolerances (max-abs-error of the output), by input dtype:

- bfloat16 3e-2: the output is rounded to bf16 (half an ulp is up to 7.8e-3
  for |o| < 4), and the flash kernel rounds P to bf16 before normalising
  where the plain version rounds after, so one output can move by a few ulp.
  The JAX package's bf16 kernel checks use 3e-2 to 5e-2.
- float16 5e-3: the same two roundings with 3 more mantissa bits.
- float32 5e-5: everything is f32 in both; only the order of the sums and
  the exponential's implementation differ, a few ulp of values below 4.

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
from .attention.flash import flash_fwd, flash_fwd_plain

TOLERANCES = {torch.bfloat16: 3e-2, torch.float16: 5e-3, torch.float32: 5e-5}
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
}


@dataclasses.dataclass
class Case:
    kernel: str                  # "flash_fwd" | "decode_attention"
    name: str
    dims: Dict[str, int]         # flash: b, t, h, d; decode: b, h, hk, T, d
    dtype: torch.dtype
    causal: bool = True
    alibi: bool = False
    lens: Optional[Tuple[int, ...]] = None      # decode: valid rows per sequence
    main_path: bool = False


CASES: List[Case] = [
    Case("flash_fwd", "gpt2-prefill", dict(b=4, t=512, h=12, d=64), torch.bfloat16,
         main_path=True),
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
]


def make_inputs(case: Case, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded inputs on ``device``. Decode caches hold 1e4 in the rows past each
    sequence's length, so a kernel that read them would show it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = case.dims

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(case.dtype)

    if case.kernel == "flash_fwd":
        bh, t, d = dims["b"] * dims["h"], dims["t"], dims["d"]
        inp = {"q": randn(bh, t, d), "k": randn(bh, t, d), "v": randn(bh, t, d)}
        if case.alibi:
            inp["slopes"] = torch.from_numpy(alibi_slopes(dims["h"])).to(device)
        return inp
    b, h, hk, cap, d = dims["b"], dims["h"], dims["hk"], dims["T"], dims["d"]
    inp = {"q": randn(b, h, d), "k": randn(b, hk, cap, d), "v": randn(b, hk, cap, d),
           "lens": torch.tensor(case.lens, dtype=torch.int32, device=device)}
    for i, n in enumerate(case.lens):
        inp["k"][i, :, n:] = 1e4
        inp["v"][i, :, n:] = 1e4
    return inp


def run_kernel(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The kernel through its public wrapper: flash ``(o, lse)``, decode ``(o,)``."""
    if case.kernel == "flash_fwd":
        return flash_fwd(inp["q"], inp["k"], inp["v"], inp.get("slopes"), None, case.causal,
                         n_heads=case.dims["h"])
    return (decode_attention(inp["q"], inp["k"], inp["v"], inp["lens"]),)


def run_plain(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The plain version on the same inputs, same outputs as :func:`run_kernel`."""
    scale = 1.0 / float(np.sqrt(case.dims["d"]))
    if case.kernel == "flash_fwd":
        return flash_fwd_plain(inp["q"], inp["k"], inp["v"], inp.get("slopes"), scale,
                               case.causal, case.dims["h"])
    return (decode_attention_plain(inp["q"], inp["k"], inp["v"], inp["lens"], scale),)


def library_fn(case: Case, inp) -> Optional[Callable[[], torch.Tensor]]:
    """One PyTorch call computing the same function, as a yardstick of speed
    only (never called by the package), or None where the installed torch
    has none."""
    dims = case.dims
    if case.kernel == "flash_fwd":
        b, t, h, d = dims["b"], dims["t"], dims["h"], dims["d"]
        q, k, v = (inp[n].view(b, h, t, d) for n in ("q", "k", "v"))
        if not case.alibi:
            return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=case.causal)
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        bias = inp["slopes"][:, None, None] * (cols - rows).float()
        if case.causal:
            bias = bias.masked_fill(cols > rows, float("-inf"))
        bias = bias.to(q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
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
    if case.kernel == "flash_fwd":
        bh, t = dims["b"] * dims["h"], dims["t"]
        pairs = t * (t + 1) // 2 if case.causal else t * t
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


def check(case: Case, device, seed: int = 0) -> Dict[str, float]:
    """Run one case; returns its errors and tolerance. Raises ``AssertionError``
    if the kernel disagrees with its plain version or returns a non-finite value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = make_inputs(case, device, seed)
    out, ref = run_kernel(case, inp), run_plain(case, inp)
    result = {"max_abs_err": max_abs_err(out[0], ref[0]), "tol": TOLERANCES[case.dtype]}
    if case.kernel == "flash_fwd":
        result["lse_err"] = max_abs_err(out[1], ref[1])
    name = f"{case.kernel}/{case.name}"
    if not all(bool(torch.isfinite(o.float()).all()) for o in out):
        raise AssertionError(f"{name}: non-finite output")
    if not result["max_abs_err"] <= result["tol"]:
        raise AssertionError(f"{name}: max abs err {result['max_abs_err']:.3e} > "
                             f"{result['tol']}")
    if not result.get("lse_err", 0.0) <= LSE_TOLERANCE:
        raise AssertionError(f"{name}: lse err {result['lse_err']:.3e} > {LSE_TOLERANCE}")
    return result


def run_kernel_checks(device) -> Dict[str, Dict[str, float]]:
    """Every case on ``device`` (a CUDA device); raises on the first failure."""
    return {f"{c.kernel}/{c.name}": check(c, device) for c in CASES}
