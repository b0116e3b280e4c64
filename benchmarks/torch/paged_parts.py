#!/usr/bin/env python3
"""Where the split decode kernels' time goes (K5, paged, or K2, dense), on one
NVIDIA card.

    python3 benchmarks/torch/paged_parts.py [paged_decode_attention|decode_attention]

Builds the checkout's ``ops/csrc/paged_decode_attention.cu`` (the default) or
``ops/csrc/decode_attention.cu`` as it is and three more times from copies of
``ops/csrc/`` under ``build/paged_parts/`` whose ``decode_split.cuh`` has one
part of the walk taken out:

- ``no-compute``: the consumer warps wait for each stage and release it
  without computing on it (the copy pipeline, the merge and the launch);
- ``no-copies``: the producer completes each stage's barrier without copying
  (the compute on stale shared memory, the merge and the launch);
- ``neither``: both (the launch, the ``cache_len`` and table reads, the
  barriers and the merge).

For every case of the kernel in ``ops/kernel_checks.py`` it times the four builds at
every split S (``chip_smoke.time_ms``: L2 flushed, median of 20), and first
the harness's own floor: one launch of a one-element ``add_``. Only the
intact build's output is a result; the others are timings of parts. Prints
``[parts]`` lines beside the card's name and power limit.
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_SKIP_COMPUTE = [("            for (int sub = 0; sub < NSUB; ++sub) {",
                  "            for (int sub = 0; sub < 0; ++sub) {")]
_SKIP_COPIES = [("hopper::mbar_arrive_expect_tx(full, 2u * stage_rows(s) * D * sizeof(T));",
                 "hopper::mbar_arrive(full);"),
                ("for (int i = lane; i < stage_units(s); i += 32) {",
                 "for (int i = lane; i < 0; i += 32) {")]
#: the builds: name -> (text as written, text as built) in decode_split.cuh
BUILDS = {"kernel": [], "no-compute": _SKIP_COMPUTE, "no-copies": _SKIP_COPIES,
          "neither": _SKIP_COMPUTE + _SKIP_COPIES}


def build_all(op_builder, kernel: str):
    """One nvcc a build, all at once; the C entry of each, with argtypes."""
    info = op_builder.KERNELS[kernel]
    procs = {}
    for name, subs in BUILDS.items():
        work = os.path.join(ROOT, "build", "paged_parts", name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(op_builder.CSRC_DIR, work)
        path = os.path.join(work, "decode_split.cuh")
        with open(path) as f:
            text = f.read()
        for line, built in subs:
            if text.count(line) != 1:
                raise RuntimeError(f"not once in decode_split.cuh: {line}")
            text = text.replace(line, built)
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(work, f"{kernel}.so")
        procs[name] = (so, subprocess.Popen(
            [op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-o", so,
             os.path.join(work, info.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-4000:]}")
        fn = getattr(ctypes.CDLL(so), info.symbol)
        fn.argtypes, fn.restype = info.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main(kernel: str) -> int:
    import torch

    import chip_smoke
    import qmm_versions
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.decode import SPLITS

    if not torch.cuda.is_available():
        print("paged_parts: no CUDA card", file=sys.stderr)
        return 2
    runs = {name: qmm_versions.runner(kernel, fn, False)
            for name, fn in build_all(op_builder, kernel).items()}
    device = torch.device("cuda", 0)
    print(f"[parts] {chip_smoke.nvidia_smi_line()}", flush=True)
    one = torch.zeros(1, device=device)
    print(f"[parts] floor: a one-element add_ {chip_smoke.time_ms(lambda: one.add_(1)):.4f} ms",
          flush=True)
    failed = False
    for case in kc.CASES:
        if case.kernel != kernel:
            continue
        pick = kc.case_splits(case)
        inp = kc.make_inputs(case, device)
        ref = kc.run_plain(case, inp)
        for s in SPLITS:
            ratio = qmm_versions.err_ratio(kc, case, runs["kernel"](case, inp, splits=s), ref)
            failed |= not ratio <= 1.0
            ms = {name: chip_smoke.time_ms(lambda: run(case, inp, splits=s))
                  for name, run in runs.items()}
            print(f"[parts] {kernel}/{case.name} S {s}{' (picked)' if s == pick else ''}: "
                  + ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
                  + f" ms; err/limit {ratio:.3f}", flush=True)
        del inp, ref
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "paged_decode_attention"))
