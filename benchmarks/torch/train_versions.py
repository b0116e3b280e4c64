#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s training phases, or its ``[main]`` serving
phase, of several checkouts on one card, in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 benchmarks/torch/train_versions.py [--sparse|--main] build/parent . . build/parent

Each argument is the root of a checkout. In the order given, each runs
``chip_smoke.train_path`` (``[train]``: dense attention), with ``--sparse``
``chip_smoke.sparse_path`` (``[sparse]``: block-sparse attention) or with
``--main`` ``chip_smoke.main_path`` (``[main]``: ``generate`` on GPT-2 125M)
from its own root in a process of its own, which builds that checkout's
kernels into its own ``build/`` (``DS_TORCH_BUILD_DIR`` is cleared). The
host moves the step between runs of one code, so compare two versions only
in turns inside one call (parent, change, change, parent). The runs' own
phase lines are printed as they come; last, one ``[train-versions]`` line a
run: its checkout, step ms (``[main]``: TTFT, TPOT and decode tokens/s), MFU
(``[train]`` only) and the traced step's (``[main]``: traced ``generate``'s)
device time, whole and in the phase's attention kernels (K1, K3, K4; K8,
K9, K10; or K2). Exits non-zero if a run fails.
"""

import json
import os
import subprocess
import sys

#: name fragments of each attention kernel's functions, by phase (16-bit
#: wgmma kernel, f32 first version)
KERNEL_KEYS = {
    "train": {"K1": ("wgmma_fwd", "flash_fwd_kernel"),
              "K3": ("wgmma_dq", "flash_bwd_dq_kernel"),
              "K4": ("wgmma_dkv", "flash_bwd_dkv_kernel")},
    "sparse": {"K8": ("wgmma_bs_fwd", "block_sparse_fwd_kernel"),
               "K9": ("wgmma_bs_dq", "block_sparse_bwd_dq_kernel"),
               "K10": ("wgmma_bs_dkv", "block_sparse_bwd_dkv_kernel")},
    # K2 on the split body, and its first version
    "main": {"K2": ("dense_decode_split<", "decode_kernel<")}}

_CHILD = """
import json, torch
import chip_smoke
phase, keys = json.loads(%r)
dev, smi = torch.device("cuda", 0), chip_smoke.nvidia_smi_line()
if phase == "main":
    # main_path keeps its trace to itself: record what profile_call returns
    traces, profile = [], chip_smoke.profile_call
    chip_smoke.profile_call = lambda *a, **kw: traces.append(profile(*a, **kw)) or traces[-1]
    out = chip_smoke.main_path(dev)
    out.update(trace=traces[-1] if traces else None, step_ms=out["tpot_ms"])
else:
    out = (chip_smoke.train_path(dev, smi) if phase == "train" else
           chip_smoke.sparse_path(dev, smi, float("nan")))
trace = out["trace"] or {"device_us": float("nan"), "by_kernel": {}}
print("[train-versions-result] " + json.dumps({
    "step_ms": out["step_ms"], "mfu": out.get("mfu"), "device_ms": trace["device_us"] / 1e3,
    "ttft_ms": out.get("ttft_ms"), "tokens_per_s": out.get("decode_tokens_per_s"),
    **{k: sum(us for name, us in trace["by_kernel"].items() if any(f in name for f in frags))
          / 1e3 for k, frags in keys.items()}}), flush=True)
"""


def main(roots, phase: str = "train") -> int:
    env = {k: v for k, v in os.environ.items() if k != "DS_TORCH_BUILD_DIR"}
    keys = KERNEL_KEYS[phase]
    results = []
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD % json.dumps([phase, keys])],
                              cwd=root, env=env, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith(f"[{phase}]"):
                print(f"  {os.path.basename(root) or root}: {line}", flush=True)
        found = [x for x in lines if x.startswith("[train-versions-result] ")]
        if proc.returncode or not found:
            print(f"[train-versions] {root} failed (rc {proc.returncode}):\n"
                  f"{proc.stderr[-4000:]}", flush=True)
            return 1
        results.append((root, json.loads(found[-1].split(" ", 1)[1])))
    for root, r in results:
        mfu = "" if r["mfu"] is None else f", MFU {r['mfu']:.4f}"
        step = (f"TTFT {r['ttft_ms']:.3f} ms, TPOT {r['step_ms']:.4f} ms, "
                f"{r['tokens_per_s']:.1f} tokens/s" if phase == "main" else
                f"step {r['step_ms']:.2f} ms{mfu}")
        print(f"[train-versions] [{phase}] {root}: {step}, traced "
              f"device {r['device_ms']:.2f} ms ("
              + ", ".join(f"{k} {r[k]:.3f}" for k in keys) + " ms)", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    phase = "sparse" if "--sparse" in args else "main" if "--main" in args else "train"
    args = [a for a in args if a not in ("--sparse", "--main")]
    if not args:
        sys.exit(__doc__)
    sys.exit(main(args, phase))
