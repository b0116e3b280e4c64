#!/usr/bin/env python3
"""Time two versions of one hand-written kernel on one NVIDIA card, in turns.

    git show <commit>:deepspeed_tpu_torch/ops/csrc/<kernel>.cu > build/<kernel>_old.cu
    python3 benchmarks/torch/qmm_versions.py <kernel> [build/<kernel>_old.cu]

``<kernel>`` is ``quantized_matmul``, ``flash_fwd``, ``flash_bwd_dq`` or
``flash_bwd_dkv``.
Builds the checkout's ``ops/csrc/<kernel>.cu`` and the old source (same flags
and C interface, ``-I`` the checkout's ``csrc/`` for its headers), prints each
build's ptxas register and spill counts, then for every case of that kernel in
``ops/kernel_checks.py``: both versions' err/limit against the plain version
and their times (old, new, new, old; ``chip_smoke.time_ms``), beside the
library yardstick and the bound. For the flash kernels it also builds the new
source with each block tiling forced (``-DDS_FLASH_FWD_WG=1|2``,
``-DDS_FLASH_DQ_WG=1|2``, ``-DDS_FLASH_DKV_WG=1|2``: one or two consumer
warpgroups a block) and times each on the 16-bit cases, the sweep behind
``fwd_warpgroups``, ``dq_warpgroups`` and ``dkv_warpgroups``, and once more
without the producer/consumer register rebalancing (``-DDS_NO_SETMAXNREG``).
For ``flash_bwd_dq`` it also builds the new source without its near-tie
recompute of ds (``-DDS_FLASH_DQ_TIE_ULPS=0``), whose err/limit is printed
and may exceed 1. Exits non-zero if another version fails a case, or a build
fails.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

#: builds that show what a part of the kernel buys: reported, not failed
DIAGNOSTIC_BUILDS = {"flash_bwd_dq": [("no-tie-recompute", ["-DDS_FLASH_DQ_TIE_ULPS=0"])]}

#: the build-time macro that forces a flash kernel's block tiling
SWEEP_MACRO = {"flash_fwd": "DS_FLASH_FWD_WG", "flash_bwd_dq": "DS_FLASH_DQ_WG",
               "flash_bwd_dkv": "DS_FLASH_DKV_WG"}


def ptxas_report(nvcc_out: str):
    name = "?"
    for line in nvcc_out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1][:100]
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  {name}: {line.split(':', 1)[-1].strip()}")


def runner(kernel: str, fn):
    """``run(case, inp)`` calling the C entry ``fn`` as the kernel's wrapper
    would, returning the wrapper's outputs."""
    import torch

    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.kernel_checks import _scale
    from deepspeed_tpu_torch.ops.quantizer import fused_matmul as fm

    def check(code, name):
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")

    def qmm(case, inp):
        x, q, s = inp["x"], inp["q"], inp["scales"]
        (m, k), (groups, n), bits = x.shape, s.shape, case.dims["bits"]
        out = torch.empty(m, n, dtype=torch.float32, device=x.device)
        chunk, splits = fm.skinny_split(m, k, n, bits)
        work = torch.empty(splits, m, n, dtype=torch.float32, device=x.device) \
            if splits > 1 else out
        check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), work.data_ptr(), m,
                 k, n, k // groups, bits, chunk, DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream), kernel)
        return (out.to(x.dtype),)

    def flash(case, inp):
        q, k, v = inp["q"], inp["k"], inp["v"]
        bh, t, d = q.shape
        slopes = inp.get("slopes")
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        tail = (bh, t, d, case.dims["h"], _scale(case), int(case.causal), DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
        sp = None if slopes is None else slopes.data_ptr()
        if kernel == "flash_fwd":
            o = torch.empty_like(q)
            lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
            check(fn(*head, sp, o.data_ptr(), lse.data_ptr(), *tail), kernel)
            return o, lse
        bwd = (inp["do"].data_ptr(), inp["lse"].data_ptr(), inp["delta"].data_ptr(), sp)
        if kernel == "flash_bwd_dq":
            dq = torch.empty_like(q)
            check(fn(*head, *bwd, dq.data_ptr(), *tail), kernel)
            return (dq,)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check(fn(*head, *bwd, dk.data_ptr(), dv.data_ptr(), *tail), kernel)
        return dk, dv

    return qmm if kernel == "quantized_matmul" else flash


def err_ratio(kc, case, out, ref) -> float:
    """The case's largest err/limit, as ``kernel_checks.check`` forms it (the
    forward's o only, then its lse against ``LSE_TOLERANCE``)."""
    atol, rtol = case.tolerance()
    pairs = list(zip(out, ref))[:1] if case.kernel in kc.FWD_KERNELS else list(zip(out, ref))
    ratio = max(kc.err_ratio(a, b, atol, rtol) for a, b in pairs)
    if case.kernel in kc.FWD_KERNELS:
        ratio = max(ratio, kc.max_abs_err(out[1], ref[1]) / kc.LSE_TOLERANCE)
    return ratio


def main(kernel: str, old_source: str) -> int:
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    if not torch.cuda.is_available():
        print("qmm_versions: no CUDA card", file=sys.stderr)
        return 2
    info = op_builder.KERNELS[kernel]
    new_source = os.path.join(op_builder.CSRC_DIR, info.source)
    builds = [("old", old_source, ["-I", op_builder.CSRC_DIR]), ("new", new_source, [])]
    if kernel in SWEEP_MACRO:
        builds += [(f"wg{n}", new_source, [f"-D{SWEEP_MACRO[kernel]}={n}"]) for n in (1, 2)]
        builds.append(("no-setmaxnreg", new_source, ["-DDS_NO_SETMAXNREG"]))
    diagnostic = DIAGNOSTIC_BUILDS.get(kernel, [])
    builds += [(tag, new_source, flags) for tag, flags in diagnostic]
    os.makedirs(op_builder.build_dir(), exist_ok=True)
    procs = []
    for tag, src, extra in builds:       # one nvcc a build, all at once
        so = os.path.join(op_builder.build_dir(), f"versions_{kernel}_{tag}.so")
        procs.append((tag, src, so, subprocess.Popen(
            [op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    runs = {}
    for tag, src, so, proc in procs:
        out, _ = proc.communicate()
        print(f"[versions] {kernel} {tag} build rc {proc.returncode}: {src}")
        if proc.returncode:
            print(out[-4000:])
            return 1
        if tag not in ("wg1", "wg2"):
            ptxas_report(out)
        fn = getattr(ctypes.CDLL(so), info.symbol)
        fn.argtypes, fn.restype = info.argtypes, ctypes.c_int
        runs[tag] = runner(kernel, fn)

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"[versions] {chip_smoke.nvidia_smi_line()}")
    failed = False
    for case in kc.CASES:
        if case.kernel != kernel:
            continue
        inp = kc.make_inputs(case, device)
        ref = kc.run_plain(case, inp)
        tags = [tag for tag in runs if tag in ("old", "new") or case.dtype != torch.float32]
        ratio = {tag: err_ratio(kc, case, runs[tag](case, inp), ref) for tag in tags}
        ms = {}
        for tag in ("old", "new", "new", "old"):
            ms.setdefault(tag, []).append(chip_smoke.time_ms(lambda: runs[tag](case, inp)))
        sweep = {tag: chip_smoke.time_ms(lambda: runs[tag](case, inp))
                 for tag in tags if tag not in ("old", "new")}
        lib = kc.library_fn(case, inp)
        lib_ms = "null" if lib is None else f"{chip_smoke.time_ms(lib):.4f}"
        failed |= not all(r <= 1.0 for tag, r in ratio.items()
                          if tag not in dict(diagnostic))
        print(f"[versions] {kernel}/{case.name} {case.dims} {str(case.dtype)[6:]}: err/limit "
              + " ".join(f"{tag} {r:.3f}" for tag, r in ratio.items())
              + f"; ms old {ms['old'][0]:.4f} / {ms['old'][1]:.4f}, new {ms['new'][0]:.4f} / "
              f"{ms['new'][1]:.4f}" + "".join(f", {tag} {t:.4f}" for tag, t in sweep.items())
              + f"; library {lib_ms}; bound {kc.bound_ms(case)[0]:.4f}", flush=True)
        del inp, ref
    return 1 if failed else 0


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "quantized_matmul"
    sys.exit(main(name, sys.argv[2] if len(sys.argv) > 2 else
                  os.path.join(ROOT, "build", f"{name}_old.cu")))
