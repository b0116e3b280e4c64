#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[train]`` phase of several checkouts on one card, in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 benchmarks/torch/train_versions.py build/parent . . build/parent

Each argument is the root of a checkout. In the order given, each runs
``chip_smoke.train_path`` from its own root in a process of its own, which
builds that checkout's kernels into its own ``build/`` (``DS_TORCH_BUILD_DIR``
is cleared). The host moves the step between runs of one code, so compare two
versions only in turns inside one call (parent, change, change, parent). The
runs' own ``[train]`` lines are printed as they come; last, one
``[train-versions]`` line a run: its checkout, step ms, MFU and the traced
step's device time, whole and in K1, K3 and K4. Exits non-zero if a run fails.
"""

import json
import os
import subprocess
import sys

#: name fragments of each flash kernel's functions (16-bit wgmma, f32 first version)
KERNEL_KEYS = {"K1": ("wgmma_fwd", "flash_fwd_kernel"),
               "K3": ("wgmma_dq", "flash_bwd_dq_kernel"),
               "K4": ("wgmma_dkv", "flash_bwd_dkv_kernel")}

_CHILD = """
import json, torch
import chip_smoke
out = chip_smoke.train_path(torch.device("cuda", 0), chip_smoke.nvidia_smi_line())
trace = out["trace"] or {"device_us": float("nan"), "by_kernel": {}}
keys = json.loads(%r)
print("[train-versions-result] " + json.dumps({
    "step_ms": out["step_ms"], "mfu": out["mfu"], "device_ms": trace["device_us"] / 1e3,
    **{k: sum(us for name, us in trace["by_kernel"].items() if any(f in name for f in frags))
          / 1e3 for k, frags in keys.items()}}), flush=True)
"""


def main(roots) -> int:
    env = {k: v for k, v in os.environ.items() if k != "DS_TORCH_BUILD_DIR"}
    results = []
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD % json.dumps(KERNEL_KEYS)],
                              cwd=root, env=env, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith("[train]"):
                print(f"  {os.path.basename(root) or root}: {line}", flush=True)
        found = [x for x in lines if x.startswith("[train-versions-result] ")]
        if proc.returncode or not found:
            print(f"[train-versions] {root} failed (rc {proc.returncode}):\n"
                  f"{proc.stderr[-4000:]}", flush=True)
            return 1
        results.append((root, json.loads(found[-1].split(" ", 1)[1])))
    for root, r in results:
        print(f"[train-versions] {root}: step {r['step_ms']:.2f} ms, MFU {r['mfu']:.4f}, traced "
              f"device {r['device_ms']:.2f} ms (K1 {r['K1']:.3f}, K3 {r['K3']:.3f}, K4 "
              f"{r['K4']:.3f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
