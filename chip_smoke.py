#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
torch + numpy; it imports nothing of JAX. Phases, in order; any failure exits
non-zero:

1. header: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel of ``deepspeed_tpu_torch/ops/csrc/``, one ``nvcc`` each,
   all at once;
3. kernel checks (``deepspeed_tpu_torch/ops/kernel_checks.py``): each kernel
   against its plain version on the card, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the bound;
4. main path: ``init_inference`` on GPT-2 125M (``bench.py``'s serving
   configuration, seeded random weights, bf16) and ``generate`` on 4 prompts
   of 512 tokens (one shortened to 384), 64 new tokens, greedy. The launch
   counts must show every prefill attention in the flash kernel and every
   decode attention in the decode kernel; the prefill logits must agree with
   the same engine run on the plain versions; one more ``generate`` is traced
   with torch.profiler to show where its device time goes;
5. training path: ``initialize`` on GPT-2 125M at ``bench.py``'s training
   configuration (vocab 50304, seq 1024, micro-batch 24, bf16 AdamW lr 2e-4,
   weight decay 0.01, ZeRO stage 1, clipping 1.0; seeded random weights, no
   remat) and 3 warm-up plus 20 timed ``train_batch`` steps on one seeded
   batch. The launch counts over the timed steps must show every attention
   forward in the flash kernel and every attention backward in the two
   backward kernels (12 layers x 20 steps each); every loss must be finite and
   the last below the first; the loss and every parameter's gradient of one
   micro-batch of 4 must agree with the plain attention's; one more
   ``train_batch`` is traced with torch.profiler.

The last lines are a JSON line of the main paths' metrics, a JSON line on the
kernels, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N_NEW = 64
PROMPT = 512
SHORT_PROMPT = 384
LOGITS_TOL = 0.1   # bf16 prefill logits, kernel vs plain attention: see main_path()
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_MICRO, TRAIN_SEQ = 20, 3, 24, 1024
GRAD_RTOL = 5e-2   # bf16 whole-model gradients, kernel vs plain attention: see train_path()
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
SPIN_CYCLES = 2_000_000   # ~1.1 ms at the H100's 1.98 GHz boost: longer than any enqueue


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times of the device work ``fn`` enqueues.
    The 50 MB L2 is flushed before each call, as a caller that streams other
    data in between would find it; then the card spins (``torch.cuda._sleep``)
    while the host enqueues ``fn``, so the time between the events is the
    device's and not the Python wrapper's."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_checks(device):
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    rows = {}
    for case in kc.CASES:
        res = kc.check(case, device, SEED)
        inp = kc.make_inputs(case, device, SEED)
        lib = kc.library_fn(case, inp)
        res.update(ms=time_ms(lambda: kc.run_kernel(case, inp)),
                   plain_ms=time_ms(lambda: kc.run_plain(case, inp), reps=5),
                   library_ms=None if lib is None else time_ms(lib))
        res["bound_ms"], res["bound_by"] = kc.bound_ms(case)
        print(f"[check] {case.kernel}/{case.name} {case.dims} {str(case.dtype)[6:]} "
              f"causal={case.causal} alibi={case.alibi} lens={case.lens}: "
              f"max_abs_err={res['max_abs_err']:.3e} err/limit={res['err_ratio']:.3g} "
              f"(limit {res['atol']:g} + {res['rtol']:g}|plain|)"
              + (f" lse_err={res['lse_err']:.3e}" if "lse_err" in res else "")
              + f" | ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} library_ms="
              + ("null" if res["library_ms"] is None else f"{res['library_ms']:.4f}")
              + f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']})", flush=True)
        if case.main_path:
            rows[case.kernel] = res
        del inp
    return rows


def plain_attention():
    """Context manager: the model's attention calls go to the plain versions
    on CUDA tensors too. Used only to make the reference run."""
    from contextlib import ExitStack
    from unittest import mock

    import numpy as np
    from deepspeed_tpu_torch.models import causal_lm
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.ops.attention.decode import decode_attention_plain

    def flash_plain(q3, k3, v3, slopes=None, softmax_scale=None, causal=True, n_heads=1):
        scale = softmax_scale or 1.0 / float(np.sqrt(q3.shape[-1]))
        return flash.flash_fwd_plain(q3, k3, v3, slopes, scale, causal, n_heads)

    def bwd_plain(plain):
        def run(q3, k3, v3, do3, lse, delta, slopes=None, softmax_scale=None, causal=True,
                n_heads=1):
            scale = softmax_scale or 1.0 / float(np.sqrt(q3.shape[-1]))
            return plain(q3, k3, v3, do3, lse, delta, slopes, scale, causal, n_heads)
        return run

    def decode_plain(q, k_cache, v_cache, cache_len):
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      1.0 / float(np.sqrt(q.shape[-1])))

    stack = ExitStack()
    stack.enter_context(mock.patch.object(flash, "flash_fwd", flash_plain))
    stack.enter_context(mock.patch.object(flash, "flash_bwd_dq",
                                          bwd_plain(flash.flash_bwd_dq_plain)))
    stack.enter_context(mock.patch.object(flash, "flash_bwd_dkv",
                                          bwd_plain(flash.flash_bwd_dkv_plain)))
    stack.enter_context(mock.patch.object(causal_lm, "decode_attention", decode_plain))
    return stack


def profile_call(label: str, fn, top: int = 12):
    """Where a call's time goes: device time by kernel, summed over one traced
    call, and the device's busy share of the call's wall time (kernels run on
    one stream, so their times do not overlap). The call must end in a
    synchronise. The tracer slows the host, so the busy share reads low
    against an untraced run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return e.self_device_time_total

    # kernels only: a CPU operator's device time repeats its kernels' times
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    if total == 0:
        print(f"[profile] {label}: the tracer recorded no device time: not measured",
              flush=True)
        return
    print(f"[profile] {label} traced: wall {wall_us / 1e3:.2f} ms, device "
          f"{total / 1e3:.2f} ms, busy share {total / wall_us:.3f}, {len(events)} kernel names",
          flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        print(f"[profile]   {device_us(e) / 1e3:8.3f} ms  {e.count:6d} calls  {e.key[:90]}",
              flush=True)


def main_path(device):
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import gpt2_cfg, init_cache
    from deepspeed_tpu_torch.ops import op_builder

    cfg = gpt2_cfg(vocab_size=50304, max_seq_len=1024, n_embd=768, n_layer=12, n_head=12)
    t0 = time.perf_counter()
    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": 1024},
                                device=device)
    torch.cuda.synchronize()
    print(f"[main] init_inference {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(4, PROMPT)).astype(np.int64)
    lens = np.array([PROMPT, PROMPT, PROMPT, SHORT_PROMPT], np.int32)

    engine.generate(ids, max_new_tokens=4, prompt_lengths=lens)      # warm-up
    op_builder.reset_launch_counts()
    out = engine.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens)
    launches = op_builder.launch_counts()
    n = out.shape[1] - PROMPT
    if out.shape != (4, PROMPT + N_NEW) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned shape {out.shape} or ids out of range")
    want = {"flash_fwd": cfg.n_layer, "decode_attention": cfg.n_layer * (n - 1),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    print(f"[main] launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    ttft, tpot, tps = engine.ttft, engine.tpot, engine.decode_tps

    # prefill logits: kernels vs plain attention, same engine, same inputs. bf16
    # activations through 12 layers, with P rounded at different points, move
    # logits of magnitude ~1 by a few bf16 ulp; LOGITS_TOL = 0.1 leaves room
    # for that and fails on any real disagreement.
    ids_dev = torch.from_numpy(ids).to(device)
    lens_dev = torch.from_numpy(lens).to(device)
    with torch.inference_mode():
        caches = init_cache(engine.model_config, 4, 1024, device=device)
        logits_k = prefill(engine.module, ids_dev, caches, lens_dev)
        with plain_attention():
            caches = init_cache(engine.model_config, 4, 1024, device=device)
            logits_p = prefill(engine.module, ids_dev, caches, lens_dev)
    if not bool(torch.isfinite(logits_k).all()) or logits_k.shape != (4, cfg.vocab_size):
        raise AssertionError(f"prefill logits non-finite or shaped {tuple(logits_k.shape)}")
    logit_err = float((logits_k - logits_p).abs().max())
    print(f"[main] prefill logits max_abs_err kernel vs plain {logit_err:.4e} "
          f"(tol {LOGITS_TOL}, |logits| max {float(logits_p.abs().max()):.3f})", flush=True)
    if not logit_err <= LOGITS_TOL:
        raise AssertionError(f"prefill logits differ by {logit_err} > {LOGITS_TOL}")
    with plain_attention():
        out_plain = engine.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens)
    agree = float((out_plain[:, PROMPT:] == out[:, PROMPT:]).mean())
    print(f"[main] greedy token agreement kernel vs plain: {agree:.4f} "
          "(not asserted: random-weight logits are near-ties)", flush=True)
    def traced_generate():
        engine.generate(ids, max_new_tokens=16, prompt_lengths=lens)
        torch.cuda.synchronize()

    profile_call("generate(16 new)", traced_generate)
    return {"ttft_ms": ttft * 1e3, "tpot_ms": tpot * 1e3, "decode_tokens_per_s": tps,
            "new_tokens": n, "launches": launches, "prefill_logit_err": logit_err,
            "token_agreement": agree}


def grads_of(engine, batch):
    """Loss and gradients of one micro-batch, from the engine's masters cast to
    the compute dtype, as a training step takes them."""
    import torch
    names = list(engine.state.params)
    loss = engine.module.loss_fn({k: p.to(engine.compute_dtype)
                                  for k, p in engine.state.params.items()}, batch)
    grads = torch.autograd.grad(loss, [engine.state.params[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def train_path(device, smi: str):
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import GPT2Config, gpt2_model
    from deepspeed_tpu_torch.ops import op_builder

    cfg = GPT2Config(vocab_size=50304, n_positions=TRAIN_SEQ, n_embd=768, n_layer=12,
                     n_head=12, dropout=0.0)
    config = {"train_batch_size": TRAIN_MICRO, "train_micro_batch_size_per_gpu": TRAIN_MICRO,
              "optimizer": {"type": "AdamW", "params": {"lr": 2e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
              "gradient_clipping": 1.0, "steps_per_print": 10**9}
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=gpt2_model(cfg), config=config, device=device)
    torch.cuda.synchronize()
    print(f"[train] initialize {time.perf_counter() - t0:.2f} s", flush=True)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ))
    batch = {"input_ids": ids}

    for _ in range(TRAIN_WARMUP):
        engine.train_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = op_builder.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_attention = cfg.n_layer * TRAIN_STEPS
    want = {"flash_fwd": per_attention, "flash_bwd_dq": per_attention,
            "flash_bwd_dkv": per_attention, "decode_attention": 0}
    print(f"[train] launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    losses = [float(x) for x in losses]
    print(f"[train] losses {losses[0]:.5f} -> {losses[-1]:.5f} over {TRAIN_STEPS} steps",
          flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_ms = dt / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_MICRO * TRAIN_SEQ * TRAIN_STEPS / dt
    mfu = tokens_per_s * cfg.flops_per_token() / PEAK_BF16_FLOPS
    print(f"[train] {smi}: step {step_ms:.2f} ms, {tokens_per_s:.1f} tokens/s, MFU {mfu:.4f} "
          f"(6N + attention FLOPs against 989 TFLOP/s), peak memory "
          f"{peak / 2**30:.2f} GiB (micro-batch {TRAIN_MICRO}, seq {TRAIN_SEQ})", flush=True)

    # the whole model on one micro-batch of 4, same weights: kernels vs plain
    # attention. bf16 activations through 12 layers, with P rounded at other
    # points in the kernels than in the plain versions, move each gradient by
    # about 1% of its norm; GRAD_RTOL = 5e-2 leaves room for that and fails on
    # any real disagreement (a dropped or misplaced attention gradient moves a
    # tensor's gradient by its whole norm).
    small = {"input_ids": torch.from_numpy(ids[:4]).to(device)}
    loss_k, grads_k = grads_of(engine, small)
    with plain_attention():
        loss_p, grads_p = grads_of(engine, small)
    loss_err = abs(float(loss_k) - float(loss_p))
    rel = {k: float((grads_k[k].float() - g.float()).norm() / g.float().norm())
           for k, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    print(f"[train] micro-batch 4, kernels vs plain attention: loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f} (|diff| {loss_err:.3e}); gradients, relative error "
          f"|g_k - g_p| / |g_p| per tensor: max {rel[worst]:.3e} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} tensors "
          f"(tol {GRAD_RTOL})", flush=True)
    if not loss_err <= 1e-2 or not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"kernels vs plain: loss diff {loss_err}, gradient {worst} "
                             f"{rel[worst]}")
    del grads_k, grads_p

    def traced_step():
        engine.train_batch(batch)
        torch.cuda.synchronize()

    profile_call("train_batch", traced_step, top=30)
    return {"step_ms": step_ms, "tokens_per_s": tokens_per_s, "mfu": mfu,
            "peak_memory_bytes": peak, "first_loss": losses[0], "last_loss": losses[-1],
            "grad_rel_err_max": rel[worst], "loss_err": loss_err, "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    smi = nvidia_smi_line()
    print(f"[header] {smi}")
    print(f"[header] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = op_builder.build(k.source for k in op_builder.KERNELS.values())
    print(f"[build] {time.perf_counter() - t0:.1f} s wall; per source {built}", flush=True)

    rows = kernel_checks(device)
    main = main_path(device)
    print(f"[main] {smi}: TTFT {main['ttft_ms']:.3f} ms, TPOT {main['tpot_ms']:.4f} ms, "
          f"decode {main['decode_tokens_per_s']:.1f} tokens/s (batch 4, prompt {PROMPT}, "
          f"{main['new_tokens']} new)", flush=True)
    train = train_path(device, smi)

    # each kernel's launches on its own main path (the one its first check case
    # is shaped by): serving for the forward and decode kernels, training for
    # the backward kernels; the forward's training launches ride beside
    kernels = []
    for name, res in rows.items():
        path = train if name in kc.BWD_KERNELS else main
        entry = {"name": name, "route": "cuda", **kc.KERNEL_INFO[name],
                 "launches": path["launches"][name],
                 "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                 "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                 "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        if name == "flash_fwd":
            entry["train_launches"] = train["launches"][name]
        kernels.append(entry)
    print(json.dumps({"main_path": {
        k: main[k] for k in ("ttft_ms", "tpot_ms", "decode_tokens_per_s",
                             "prefill_logit_err", "token_agreement")},
        "train_path": {k: train[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                             "peak_memory_bytes", "first_loss", "last_loss",
                                             "grad_rel_err_max", "loss_err")}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
