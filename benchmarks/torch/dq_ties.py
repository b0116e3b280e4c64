#!/usr/bin/env python3
"""How far K3's tensor-core ds lies from its in-order f32 value, on one NVIDIA card.

    python3 benchmarks/torch/dq_ties.py [case ...]

K3 (``ops/csrc/flash_bwd_dq.cu``) rounds ds to the input dtype from the
tensor cores' f32 sums, except where that value lies within ``TIE_ULPS`` f32
ulps of a rounding boundary: there it recomputes the element in order
(``dots_in_order``). This script builds a copy of the source into ``build/``
in which every element with |ds| >= 2^-6 (the floor of the near-tie test)
takes that recompute path, and counts, for those elements, the distance
between the two f32 values in f32 ulps (power-of-two buckets) and the
elements whose rounding to the input dtype differs between the two. The
widest bucket that holds elements is what ``TIE_ULPS`` has to cover. Runs the
16-bit ``flash_bwd_dq`` cases of ``ops/kernel_checks.py`` named (default:
all) on seed 0 and prints one line a case.

Then, for the training case, it builds the source without the recompute
(``-DDS_FLASH_DQ_TIE_ULPS=0``), finds the dq element furthest outside its
limit, and prints that element's kernel, plain and float64 values (ds
computed in float64 and rounded to the input dtype), and each ds of its row
that the plain version's f32 evaluation rounds otherwise than its float64
value.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: (text in flash_bwd_dq.cu, what the counting copy puts there)
PATCHES = [
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n'
     "__device__ unsigned long long g_ties[34];   // ulp buckets, flips, elements\n"
     "template <typename T> __device__ void count_tie(float tc, float ordered) {\n"
     "    const uint32_t a = __float_as_uint(tc), b = __float_as_uint(ordered);\n"
     "    const uint32_t dist = a > b ? a - b : b - a;\n"
     "    atomicAdd(&g_ties[dist == 0 ? 0 : min(32 - __clz(dist), 31)], 1ull);\n"
     "    if (round_to<T>(tc) != round_to<T>(ordered)) atomicAdd(&g_ties[32], 1ull);\n"
     "    atomicAdd(&g_ties[33], 1ull);\n"
     "}\n"
     'extern "C" int dq_ties(unsigned long long* out) {\n'
     "    unsigned long long zero[34] = {0};\n"
     "    cudaDeviceSynchronize();\n"
     "    cudaMemcpyFromSymbol(out, g_ties, sizeof(zero));\n"
     "    cudaMemcpyToSymbol(g_ties, zero, sizeof(zero));\n"
     "    return (int)cudaGetLastError();\n"
     "}\n"),
    ("if (near_tie<T>(ds) && row < t)", "if (fabsf(ds) >= 0.015625f && row < t)"),
    ("if (u == i) dp[u] = ds;", "if (u == i) {\n count_tie<T>(dp[u], ds);\n dp[u] = ds;\n}"),
]


def main(names) -> int:
    import torch

    import qmm_versions
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    if not torch.cuda.is_available():
        print("dq_ties: no CUDA card", file=sys.stderr)
        return 2
    info = op_builder.KERNELS["flash_bwd_dq"]
    with open(os.path.join(op_builder.CSRC_DIR, info.source)) as f:
        text = f.read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            print(f"dq_ties: the source no longer holds, once: {old!r}", file=sys.stderr)
            return 1
        text = text.replace(old, new)
    os.makedirs(op_builder.build_dir(), exist_ok=True)
    src = os.path.join(op_builder.build_dir(), "dq_ties.cu")
    so = os.path.join(op_builder.build_dir(), "dq_ties.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-I", op_builder.CSRC_DIR,
                    "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, info.symbol)
    fn.argtypes, fn.restype = info.argtypes, ctypes.c_int
    run = qmm_versions.runner("flash_bwd_dq", fn)
    counts = (ctypes.c_ulonglong * 34)()
    device = torch.device("cuda", 0)
    for case in kc.CASES:
        if (case.kernel != "flash_bwd_dq" or case.dtype == torch.float32
                or (names and case.name not in names)):
            continue
        inp = kc.make_inputs(case, device)
        lib.dq_ties(counts)
        run(case, inp)
        lib.dq_ties(counts)
        c = list(counts)
        buckets = " ".join(f"<{1 << b}:{n}" for b, n in enumerate(c[:32]) if n)
        print(f"[dq-ties] {case.name} {case.dims} {str(case.dtype)[6:]}: {c[33]} elements with "
              f"|ds| >= 2^-6, {c[32]} round otherwise from their tensor-core value; f32 ulps "
              f"apart (count below each power of two) {buckets}", flush=True)
        del inp
    worst_element(kc, info, device)
    return 0


def worst_element(kc, info, device):
    import torch

    import qmm_versions
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention import flash

    so = os.path.join(op_builder.build_dir(), "dq_no_tie.so")
    subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-DDS_FLASH_DQ_TIE_ULPS=0",
                    "-o", so, os.path.join(op_builder.CSRC_DIR, info.source)], check=True)
    fn = getattr(ctypes.CDLL(so), info.symbol)
    fn.argtypes, fn.restype = info.argtypes, ctypes.c_int
    case = next(c for c in kc.CASES if c.kernel == "flash_bwd_dq" and c.main_path)
    inp = kc.make_inputs(case, device)
    out = qmm_versions.runner("flash_bwd_dq", fn)(case, inp)[0].float()
    ref = kc.run_plain(case, inp)[0].float()
    atol, rtol = case.tolerance()
    ratio = (out - ref).abs() / (atol + rtol * ref.abs())
    n, r, c = (int(x) for x in torch.nonzero(ratio == ratio.max())[0])
    scale = kc._scale(case)
    q, k, v, do = (inp[x][n] for x in ("q", "k", "v", "do"))
    lse, delta = inp["lse"][n, r], inp["delta"][n, r]
    cols = r + 1 if case.causal else case.dims["t"]

    # p (dp - delta) scale of row r before its rounding: in float64, and as
    # the plain version takes it (flash._probs_and_ds, the same batched calls)
    q1, k1, v1, do1 = (x.double() for x in (q[r], k[:cols], v[:cols], do[r]))
    exact = torch.exp(k1 @ q1 * scale - lse.double()) * (v1 @ do1 - delta.double()) * scale
    s = flash._scores(inp["q"], inp["k"], None, scale, case.causal, 1)[n, r, :cols]
    dp = torch.einsum("ntd,nsd->nts", inp["do"].float(), inp["v"].float())[n, r, :cols]
    plain = torch.exp(s - lse) * (dp - delta) * scale
    ds64 = exact.to(case.dtype).double()
    flips = torch.nonzero(ds64 != plain.to(case.dtype).double()).flatten().tolist()
    print(f"[dq-ties] {case.name} without the recompute: worst dq element (head {n}, row {r}, "
          f"column {c}) err/limit {float(ratio.max()):.4g}: kernel {float(out[n, r, c]):.6f}, "
          f"plain {float(ref[n, r, c]):.6f}, float64 {float(ds64 @ k[:cols, c].double()):.6f}",
          flush=True)
    for j in flips:
        print(f"[dq-ties]   ds at column {j}: float64 {float(exact[j]):.10f}, plain f32 "
              f"{float(plain[j]):.10f}, rounded {float(ds64[j]):.6f} and "
              f"{float(plain[j].to(case.dtype)):.6f}; k[{j}, {c}] = {float(k[j, c]):.4f}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
