#!/usr/bin/env python3
"""Time two versions of the dequant-GEMM kernel on one NVIDIA card, in turns.

    git show <commit>:deepspeed_tpu_torch/ops/csrc/quantized_matmul.cu > build/qmm_old.cu
    python3 benchmarks/torch/qmm_versions.py build/qmm_old.cu

Builds the checkout's ``ops/csrc/quantized_matmul.cu`` (through its wrapper)
and the old source (same flags and C interface, ``-I`` the checkout's
``csrc/`` for its headers), prints each build's ptxas register and spill
counts, then for every dequant-GEMM case of ``ops/kernel_checks.py``: both
versions' err/limit against the plain version and their times (old, new,
new, old; ``chip_smoke.time_ms``), beside cuBLAS bf16 and the bound.
Exits non-zero if either version fails a case or a build.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def ptxas_report(nvcc_out: str):
    name = "?"
    for line in nvcc_out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1][:100]
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  {name}: {line.split(':', 1)[-1].strip()}")


def main(old_source: str) -> int:
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.quantizer import fused_matmul as fm

    if not torch.cuda.is_available():
        print("qmm_versions: no CUDA card", file=sys.stderr)
        return 2
    os.makedirs(op_builder.build_dir(), exist_ok=True)
    libs = {}
    for tag, src, extra in (("old", old_source, ["-I", op_builder.CSRC_DIR]),
                            ("new", os.path.join(op_builder.CSRC_DIR, "quantized_matmul.cu"), [])):
        so = os.path.join(op_builder.build_dir(), f"qmm_versions_{tag}.so")
        proc = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v", *extra,
                               "-o", so, src], capture_output=True, text=True)
        print(f"[versions] {tag} build rc {proc.returncode}: {src}")
        if proc.returncode:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            return 1
        ptxas_report(proc.stdout + proc.stderr)
        fn = getattr(ctypes.CDLL(so), "quantized_matmul")
        fn.argtypes, fn.restype = fm.QUANTIZED_MATMUL.argtypes, ctypes.c_int
        libs[tag] = fn

    def run(tag, case, inp):
        x, q, s = inp["x"], inp["q"], inp["scales"]
        (m, k), (groups, n), bits = x.shape, s.shape, case.dims["bits"]
        out = torch.empty(m, n, dtype=torch.float32, device=x.device)
        chunk, splits = fm.skinny_split(m, k, n, bits)
        work = torch.empty(splits, m, n, dtype=torch.float32, device=x.device) \
            if splits > 1 else out
        code = libs[tag](x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                         work.data_ptr(), m, k, n, k // groups, bits, chunk,
                         DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{tag}: CUDA error {code}")
        return out.to(x.dtype)

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"[versions] {chip_smoke.nvidia_smi_line()}")
    failed = False
    for case in kc.CASES:
        if case.kernel != "quantized_matmul":
            continue
        inp = kc.make_inputs(case, device)
        ref = kc.run_plain(case, inp)[0]
        ratio = {tag: kc.err_ratio(run(tag, case, inp), ref, *case.tolerance()) for tag in libs}
        ms = {}
        for tag in ("old", "new", "new", "old"):
            ms.setdefault(tag, []).append(chip_smoke.time_ms(lambda: run(tag, case, inp)))
        lib = chip_smoke.time_ms(kc.library_fn(case, inp))
        failed |= not all(r <= 1.0 for r in ratio.values())
        print(f"[versions] {case.name}: err/limit old {ratio['old']:.3f} new {ratio['new']:.3f}; "
              f"ms old {ms['old'][0]:.4f} / {ms['old'][1]:.4f}, new {ms['new'][0]:.4f} / "
              f"{ms['new'][1]:.4f}; cuBLAS bf16 {lib:.4f}; bound {kc.bound_ms(case)[0]:.4f}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build", "qmm_old.cu")))
