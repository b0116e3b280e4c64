#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training-feature phases alone, on one NVIDIA card.

    python3 benchmarks/torch/train_features.py [phase ...]

Builds the kernels, then calls the phase functions of ``chip_smoke.py``
(default all four: ``lm_train_path``, ``moe_train_path``, ``dropout_path``,
``optim_path``) with their gates; prints each phase's seconds and one JSON
line of their results with the card's name and power limit. Exits non-zero
if a phase fails a gate. About 2 minutes on an H100.
"""

import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("lm_train_path", "moe_train_path", "dropout_path", "optim_path")


def main() -> int:
    phases = sys.argv[1:] or list(PHASES)
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"train_features: unknown phases {unknown}; known: {list(PHASES)}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("train_features: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from deepspeed_tpu_torch.ops import op_builder

    smi = chip_smoke.nvidia_smi_line()
    print(f"[header] {smi}", flush=True)
    t0 = time.perf_counter()
    op_builder.build(k.source for k in op_builder.KERNELS.values())
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda", 0)
    out = {}
    for name in phases:
        t0 = time.perf_counter()
        out[name] = getattr(chip_smoke, name)(device, smi)
        print(f"[phase] {name} {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "phases": out}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
