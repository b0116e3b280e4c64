#!/usr/bin/env python3
"""Time one kernel's ``[check]`` cases in several checkouts, in turns, on one
NVIDIA card.

    git archive <commit> | tar -x -C build/parent
    python3 benchmarks/torch/check_versions.py decode_attention build/parent . . build/parent

Each checkout runs in a process of its own, importing its own package and
building its kernels into its own ``build/torch_kernels/``. There every case
of the kernel in ``ops/kernel_checks.py`` is checked against the plain
version and timed through the public wrapper as ``chip_smoke.py``'s
``[check]`` times it (``time_ms``: L2 flushed, median of 20): one ``[turns]``
line a case a checkout. Exits non-zero if a checkout fails a case.
"""

import os
import subprocess
import sys


def child(kernel: str, root: str) -> None:
    sys.path.insert(0, root)
    os.environ["DS_TORCH_BUILD_DIR"] = os.path.join(root, "build", "torch_kernels")
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc

    if not kc.__file__.startswith(root):
        raise RuntimeError(f"imported {kc.__file__}, not the package under {root}")
    device = torch.device("cuda", 0)
    for case in kc.CASES:
        if case.kernel != kernel:
            continue
        res = kc.check(case, device)
        inp = kc.make_inputs(case, device)
        ms = chip_smoke.time_ms(lambda: kc.run_kernel(case, inp))
        print(f"[turns] {root} {kernel}/{case.name}: ms {ms:.4f} err/limit "
              f"{res['err_ratio']:.3g}", flush=True)
        del inp


def main(kernel: str, roots) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))
    import chip_smoke
    print(f"[turns] {chip_smoke.nvidia_smi_line()}", flush=True)
    rc = 0
    for root in roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child", kernel,
                              os.path.abspath(root)]).returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2:]))
