#!/usr/bin/env python3
"""Time kernels' ``[check]`` cases in several checkouts, in turns, on one
NVIDIA card.

    git archive <commit> | tar -x -C build/parent
    python3 benchmarks/torch/check_versions.py decode_attention build/parent . . build/parent
    python3 benchmarks/torch/check_versions.py flash_fwd:gpt2-prefill,decode_attention:gpt2-decode \
        build/parent . . build/parent

The first argument is one or more selectors of ``kernel_checks.selects``,
joined by commas: a kernel's name takes every case of it, ``kernel:tag``
its cases with that tag (a case's name, its dtype). Each checkout runs in a
process of its own, importing its own package and building the selected
kernels (all at once) into its own ``build/torch_kernels/``. There every
selected case that the checkout's ``ops/kernel_checks.py`` has is checked
against the plain version and timed through the public wrapper as
``chip_smoke.py``'s ``[check]`` times it (``time_ms``: L2 flushed, median of
20): one ``[turns]`` line a case a checkout. Exits non-zero if a checkout
fails a case.
"""

import os
import subprocess
import sys


def child(selectors: str, root: str) -> None:
    sys.path.insert(0, root)
    os.environ["DS_TORCH_BUILD_DIR"] = os.path.join(root, "build", "torch_kernels")
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    if not kc.__file__.startswith(root):
        raise RuntimeError(f"imported {kc.__file__}, not the package under {root}")
    device = torch.device("cuda", 0)
    cases = [c for c in kc.CASES if any(kc.selects(s, c) for s in selectors.split(","))]
    op_builder.build(sorted({op_builder.KERNELS[c.kernel].source for c in cases}))
    for case in cases:
        res = kc.check(case, device)
        inp = kc.make_inputs(case, device)
        ms = chip_smoke.time_ms(lambda: kc.run_kernel(case, inp))
        print(f"[turns] {root} {case.kernel}/{case.name}: ms {ms:.4f} err/limit "
              f"{res['err_ratio']:.3g}", flush=True)
        del inp


def main(selectors: str, roots) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))
    import chip_smoke
    print(f"[turns] {chip_smoke.nvidia_smi_line()}", flush=True)
    rc = 0
    for root in roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child", selectors,
                              os.path.abspath(root)]).returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2:]))
