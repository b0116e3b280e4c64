#!/usr/bin/env python3
"""Read ``[offload]`` lane A's update parity at other seeds, on one NVIDIA card.

    python3 benchmarks/torch/offload_parity.py [--seeds 0 1]

For each seed, ``chip_smoke.offload_lane_a`` trains GPT-2 1.3B as
``bench.py``'s offload lane does (remat ``dots``, micro-batch 4, seq 1024,
bf16 AdamW, ZeRO stage 3), with and without ``offload_optimizer: cpu`` and
once with the planted fault (the host moments never written), on a batch
drawn from the seed and weights from 42 + seed (seed 0 is what
``chip_smoke.py`` runs). Every gate of the lane applies; the parity lines
(the median and the worst tensor of ``|dp - dp_device| / |dp_device|``, for
offload and for the fault) are printed by the lane, and one ``[parity]``
JSON line at the end gathers them by seed with the card's name and power
limit. Exits non-zero if a seed fails a gate.
"""

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("offload_parity: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from deepspeed_tpu_torch.ops import op_builder

    smi = chip_smoke.nvidia_smi_line()
    print(f"[header] {smi}", flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    op_builder.build(k.source for k in op_builder.KERNELS.values())
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    keys = ("parity_median", "parity_max", "parity_worst", "fault_parity_median",
            "fault_parity_max", "fault_parity_worst")
    readings = {}
    for seed in args.seeds:
        print(f"[parity] seed {seed}", flush=True)
        lane = chip_smoke.offload_lane_a(device, smi, seed=seed)
        readings[seed] = {k: lane["offload"][k] for k in keys}
        readings[seed]["step_ms"] = {run: lane[run]["step_ms"] for run in ("in_device",
                                                                           "offload")}
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "limits": {"median": chip_smoke.OFFLOAD_PARITY,
                                                "max": chip_smoke.OFFLOAD_PARITY_MAX},
                      "by_seed": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
