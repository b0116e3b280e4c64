#!/usr/bin/env python3
"""Time the selected-expert FFN (K7) against an older source of it, and its
design's parts one at a time, in turns, on one NVIDIA card.

    git show <commit>:deepspeed_tpu_torch/ops/csrc/moe_decode_ffn.cu > build/moe_decode_ffn_old.cu
    python3 benchmarks/torch/moe_parts.py build/moe_decode_ffn_old.cu [--step] [case ...]

Builds the old source (the first version's C arguments: no mode), this
checkout's ``ops/csrc/moe_decode_ffn.cu``, and that source with the
reduction after the tensor-core kernel launched as a plain launch instead
of a programmatic dependent (``no-pdl``), every build at once, one ``nvcc``
each with ``-Xptxas -v``, into ``build/moe_parts/``. For each ``[check]``
case of the selected-expert FFN in this checkout's ``ops/kernel_checks.py``
(or the cases named) it runs: the old source at its wrapper's f-block
width (``old_block_f``); the new one at the wrapper's plan (``moe_plan``);
where the plan takes the tensor-core kernel, the new build's slab kernel at
the old width (what the tensor-core kernel buys in the same build) and the
``no-pdl`` build. Each is checked against the plain version (err/limit, as
``[check]`` holds it) and timed as ``chip_smoke.py``'s ``[check]`` times it
(``time_ms``: L2 flushed, median of 20), in turns: old, new, the rest, new,
old. One ``[parts]`` line a case: each run's times, the bound, and the time
of a PyTorch read of the same expert bytes (``torch.sum`` over the selected
experts' w1 and w2: what streaming them costs under this timing).

With ``--step``, first ``[moe]``'s decode step (GPT-2 125M, every 2nd FFN
top-1 of 8 experts, bf16, batch 1, after a 512-token prefill: K7 at n 1,
six calls a step) runs through the model with each build's K7 in turns
(old, new, no-pdl, no-pdl, new, old), traced ``STEP_TRACES`` times a turn
by ``chip_smoke.profile_call``. One ``[step]`` line a turn: the medians of
K7's summed kernel times, of K7's span (``chip_smoke.k7_span_us``: each
call's FFN start to its reduction's end, summed) and of the step's device
time. Exits non-zero if a run fails a case.
"""

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PDL_LAUNCH = "return launch_reduce<T>(p, true, st);"   # in launch_mma
STEP_TRACES = 5


def old_block_f(n: int, f: int) -> int:
    """The first version's f-block width: the widest of 128, 64, 32, 16 for
    which n * cdiv(f, bf) blocks reach 96, else 16."""
    for bf in (128, 64, 32, 16):
        if n * -(-f // bf) >= 96:
            return bf
    return 16


def build(old_source: str):
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.moe.decode_ffn import MOE_DECODE_FFN
    out = os.path.join(REPO, "build", "moe_parts")
    os.makedirs(out, exist_ok=True)
    new_source = os.path.join(op_builder.CSRC_DIR, "moe_decode_ffn.cu")
    text = open(new_source).read()
    if text.count(PDL_LAUNCH) != 1:
        raise RuntimeError(f"{new_source} has no single {PDL_LAUNCH!r} to build no-pdl from")
    no_pdl = os.path.join(out, "moe_decode_ffn_no_pdl.cu")
    with open(no_pdl, "w") as fh:
        fh.write(text.replace(PDL_LAUNCH, PDL_LAUNCH.replace("true", "false")))
    builds = [("old", old_source), ("new", new_source), ("no-pdl", no_pdl)]
    procs = []
    for name, src in builds:
        so = os.path.join(out, name + ".so")
        cmd = [op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", op_builder.CSRC_DIR, "-o", so, src]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"[parts] build {name}: {'spills ' + '; '.join(spills) if spills else 'no spills'}",
              flush=True)
        fn = ctypes.CDLL(so).moe_decode_ffn
        types = list(MOE_DECODE_FFN.argtypes)
        fn.argtypes = types[:13] + types[14:] if name == "old" else types
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def wrapper_entry(fn, old: bool):
    """``fn`` called with the wrapper's C arguments: the old source takes no
    mode and runs at its own f-block width (no narrower than the plan's, so
    the wrapper's partials hold it)."""
    if not old:
        return fn

    def call(*args):
        n, f, bf = args[8], args[10], args[12]
        obf = old_block_f(n, f)
        assert obf >= bf, (obf, bf)
        return fn(*args[:12], obf, *args[14:])
    return call


def step_turns(libs, device) -> None:
    """``[moe]``'s decode step with each build's K7, in turns."""
    import numpy as np
    import torch

    import chip_smoke
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode_fns import prefill
    from deepspeed_tpu_torch.models import gpt2_cfg, init_cache
    from deepspeed_tpu_torch.ops.moe.decode_ffn import MOE_DECODE_FFN

    cfg = gpt2_cfg(vocab_size=50304, max_seq_len=2048, n_embd=768, n_layer=12, n_head=12,
                   num_experts=8)
    prompt = chip_smoke.MOE_PROMPT
    engine = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": prompt + 8},
                                device=device)
    ids = torch.from_numpy(np.random.default_rng(chip_smoke.SEED).integers(
        0, cfg.vocab_size, (1, prompt))).to(device)
    lens = torch.full((1,), prompt, dtype=torch.int32, device=device)
    wrapper_fn = MOE_DECODE_FFN._load()     # the new build, loaded as the wrapper loads it
    with torch.inference_mode():
        caches = init_cache(engine.model_config, 1, prompt + 8, device=device)
        tok = prefill(engine.module, ids, caches, lens).argmax(-1)[:, None]

        def step():
            engine.module(tok, positions=lens[:, None], caches=caches, cache_lens=lens)
            torch.cuda.synchronize()

        for name in ("old", "new", "no-pdl", "no-pdl", "new", "old"):
            MOE_DECODE_FFN._fn = wrapper_entry(libs[name], name == "old")
            for _ in range(3):
                step()
            traces = [chip_smoke.profile_call(f"[step] {name}", step, top=0)
                      for _ in range(STEP_TRACES)]
            if any(t is None for t in traces):
                print(f"[step] {name}: the tracer recorded no device time: not measured",
                      flush=True)
                continue
            k7 = [sum(v for k, v in t["by_kernel"].items() if "moe_ffn" in k) / 1e3
                  for t in traces]
            span = [chip_smoke.k7_span_us(t) / 1e3 for t in traces]
            dev = [t["device_us"] / 1e3 for t in traces]
            print(f"[step] {name}: K7 kernels {statistics.median(k7):.4f} ms, K7 span "
                  f"{statistics.median(span):.4f} ms, step device {statistics.median(dev):.4f} "
                  f"ms (medians of {STEP_TRACES} traced steps; spans "
                  f"{' '.join(f'{v:.4f}' for v in span)})", flush=True)
    MOE_DECODE_FFN._fn = wrapper_fn
    del engine, caches


def main(old_source: str, names, step: bool) -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.moe.decode_ffn import ACT_CODES, SLAB, moe_plan

    print(f"[parts] {chip_smoke.nvidia_smi_line()}", flush=True)
    libs = build(os.path.abspath(old_source))
    device = torch.device("cuda", 0)
    if step:
        step_turns(libs, device)
    cases = [c for c in kc.CASES if c.kernel == "moe_decode_ffn" and (not names or
                                                                     c.name in names)]
    rc = 0
    for case in cases:
        inp = kc.make_inputs(case, device)
        x, idx, w1, b1, w2, b2 = (inp[k] for k in ("x", "idx", "w1", "b1", "w2", "b2"))
        n, d = x.shape
        e, _, f = w1.shape
        ref = kc.run_plain(case, inp)[0]
        atol, rtol = case.tolerance()

        def caller(fn, bf, mode):
            part = torch.empty(n, -(-f // bf), d, device=device)
            args = () if mode is None else (mode,)

            def call():
                y = torch.empty(n, d, device=device)
                code = fn(x.data_ptr(), idx.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                          w2.data_ptr(), b2.data_ptr(), part.data_ptr(), y.data_ptr(), n, d, f,
                          e, bf, *args, ACT_CODES[case.activation], DTYPE_CODES[x.dtype],
                          torch.cuda.current_stream(device).cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed with CUDA error {code}")
                return y
            return call

        bf, mode = moe_plan(n, d, f, x.element_size())
        runs = {"old": caller(libs["old"], old_block_f(n, f), None),
                f"new(bf {bf}, mode {mode})": caller(libs["new"], bf, mode)}
        if mode != SLAB:
            runs["slab"] = caller(libs["new"], old_block_f(n, f), SLAB)
            runs["no-pdl"] = caller(libs["no-pdl"], bf, mode)
        ratios = {}
        for name, call in runs.items():
            y = call()
            torch.cuda.synchronize()
            ratios[name] = kc.err_ratio(y, ref, atol, rtol)
            if not ratios[name] <= 1.0:
                rc = 1
        names_ = list(runs)
        order = names_[:2] + names_[2:] + names_[1::-1]
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(chip_smoke.time_ms(runs[name]))
        experts = sorted(set(kc.moe_inputs_idx(case)))
        sel = torch.tensor(experts, device=device)
        w1s, w2s = w1[sel].contiguous(), w2[sel].contiguous()
        read_ms = chip_smoke.time_ms(lambda: (w1s.sum(), w2s.sum()))
        print(f"[parts] {case.name} {case.dims} {str(case.dtype)[6:]}: "
              + "; ".join(f"{name} ms {' '.join(f'{t:.4f}' for t in times[name])} err/limit "
                          f"{ratios[name]:.3g}" for name in runs)
              + f"; bound {kc.bound_ms(case)[0]:.4f}; torch read of the experts {read_ms:.4f}"
              + f"; old block_f {old_block_f(n, f)}", flush=True)
        del inp, runs, w1s, w2s
    return rc


if __name__ == "__main__":
    argv = sys.argv[1:]
    sys.exit(main(argv[0], [a for a in argv[1:] if a != "--step"], "--step" in argv[1:]))
