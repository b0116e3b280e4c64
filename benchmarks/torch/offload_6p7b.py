#!/usr/bin/env python3
"""Try GPT-2 6.7B under ZeRO-Offload on one card, if the host has the memory.

    python3 benchmarks/torch/offload_6p7b.py [--steps 2]

GPT-2 6.7B (width 4096, 32 layers, vocab 50304, seq 1024) needs about 16
bytes a parameter of device state without offload (f32 master, two Adam
moments, f32 gradient): about 106 GB, more than an 80 GB card. With
``offload_optimizer: cpu`` the masters and moments live in pinned host memory
instead, beside pinned bf16 transfer buffers each way: the tier's host bytes
are predicted here from the parameter count. The script reads
``MemAvailable`` from ``/proc/meminfo`` and trains (remat ``full``,
micro-batch 1, bf16 AdamW, stage 3 + offload, seeded random weights and
batch) only if it holds 1.3 x the tier's bytes; otherwise it prints the
figures and exits 0 without touching the card. Prints the card's name and
power limit, the host memory, and for a run the peak device memory, each
step's time and the host memory left.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))))

HEADROOM = 1.3


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def tier_host_bytes(n_params: int, largest: int) -> int:
    """Masters and both moments in f32, the bf16 gradient and staging
    buffers, the f32 copy of one gradient (``OffloadOptimizerTier``,
    ``DeepSpeedCPUAdam``)."""
    return 12 * n_params + 2 * n_params + 2 * n_params + 4 * largest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2_model
    from deepspeed_tpu_torch.models.gpt2 import gpt2_config

    if not torch.cuda.is_available():
        print("offload_6p7b: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = gpt2_config("gpt2-6.7b", vocab_size=50304, n_positions=1024, dropout=0.0,
                      remat=True, remat_policy="full")
    n = cfg.num_params()
    need = tier_host_bytes(n, cfg.vocab_size * cfg.n_embd)
    avail = mem_available_bytes()
    print(f"[6.7b] {smi}: GPT-2 6.7B, {n:,} parameters; in-device state 16 B x n = "
          f"{16 * n / 1e9:.1f} GB against the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; the offload "
          f"tier's host bytes {need / 1e9:.1f} GB, x {HEADROOM} = {HEADROOM * need / 1e9:.1f} "
          f"GB; MemAvailable {avail / 1e9:.1f} GB", flush=True)
    if avail < HEADROOM * need:
        print(f"[6.7b] not run: MemAvailable {avail / 1e9:.1f} GB < {HEADROOM} x the tier's "
              f"{need / 1e9:.1f} GB", flush=True)
        return 0
    config = {"train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": True},
              "zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"}},
              "gradient_clipping": 1.0, "steps_per_print": 10**9}
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=gpt2_model(cfg), config=config)
    print(f"[6.7b] initialize {time.perf_counter() - t0:.1f} s; the tier holds "
          f"{engine._offload_tier.host_bytes() / 1e9:.1f} GB of host memory; MemAvailable "
          f"now {mem_available_bytes() / 1e9:.1f} GB", flush=True)
    ids = np.random.default_rng(0).integers(0, 50304, size=(1, 1024), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss = float(engine.train_batch({"input_ids": ids}))
        torch.cuda.synchronize()
        hs = engine._offload_tier.last_step_s
        print(f"[6.7b] {smi}: step {step + 1}: {time.perf_counter() - t0:.2f} s, loss "
              f"{loss:.4f}, host update {hs['host_update_s']:.2f} s, waiting on the "
              f"gradients {hs['d2h_wait_s']:.2f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; MemAvailable "
              f"{mem_available_bytes() / 1e9:.1f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
