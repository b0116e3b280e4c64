#!/usr/bin/env python3
"""Time two versions of one hand-written kernel on one NVIDIA card, in turns.

    git show <commit>:deepspeed_tpu_torch/ops/csrc/<kernel>.cu > build/<kernel>_old.cu
    python3 benchmarks/torch/qmm_versions.py <kernel> [build/<kernel>_old.cu]
or, with the old source's own headers, from its whole tree:
    git archive <commit> | tar -x -C build/parent
    python3 benchmarks/torch/qmm_versions.py <kernel> build/parent

``<kernel>`` is ``quantized_matmul``, ``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``, ``block_sparse_fwd``, ``block_sparse_bwd_dq``,
``block_sparse_bwd_dkv``, ``paged_decode_attention`` or ``decode_attention``.
Builds the checkout's ``ops/csrc/<kernel>.cu`` and the old source (same flags).
Given a tree, the old source is its ``deepspeed_tpu_torch/ops/csrc/<kernel>.cu``
and ``-I`` that ``csrc/``, so every header is the old tree's; given a file,
``-I`` the checkout's ``csrc/`` (a header the old source needs as it was
goes beside it, ``git show <commit>:.../csrc/<header>.cuh >
build/<header>.cuh``, and is found first). Where the C entry changed,
the old source is called with its own argument list, ``OLD_ARGTYPES``: for
``block_sparse_fwd``, ``block_sparse_bwd_dq`` and ``block_sparse_bwd_dkv``
the first version's, without tile tables, the new one taking the case's tile
tables, built before the timing; for
``quantized_matmul`` the version without bias or tiling, called with the
skinny split of its own wrapper, ``old_skinny_split``, and cast to x's dtype
as that wrapper did, so at m = 1 the old build is the CUDA-core
``qmm_skinny<T, 1>`` and the two m = 1 cases are the sweep of the wgmma
kernel against it), prints each build's ptxas register and spill counts, then
for every case of that kernel in ``ops/kernel_checks.py``: both versions'
err/limit against the plain version and their times (old, new, new, old;
``chip_smoke.time_ms``), beside the library yardstick and the bound. For the
flash wgmma kernels it also builds the new source with each block tiling
forced (``-DDS_FLASH_FWD_WG=1|2``, ``-DDS_FLASH_DQ_WG=1|2``,
``-DDS_FLASH_DKV_WG=1|2``: one or two consumer warpgroups a block) and times
each on the 16-bit cases, the sweep behind ``fwd_warpgroups``,
``dq_warpgroups`` and ``dkv_warpgroups``, and once more without the
producer/consumer register rebalancing (``-DDS_NO_SETMAXNREG``).
For ``quantized_matmul`` it then times the new build at every bf16 tiling
(wgmma N of 8, 16 and 128 rows of x, forced through the C entry's
``tile_m``, each with its split from ``qmm_split``) at m from 1 to 64 on
BLOOM-7B's q_proj (int8) and fc_out (int4) shapes: the regime switch of
``qmm_plan`` (``[switch]`` lines).
For ``block_sparse_bwd_dq`` and ``block_sparse_bwd_dkv`` it also times, on
each 16-bit case, the new build with every walk but the longest emptied
(``[tail]`` lines, ``walk_tail``).
For ``paged_decode_attention`` the old source is the first version's (one
block a (slot, kv head), over that tree's own headers: pass the tree of a
commit before the cluster split), called without ``splits``;
each case's line also times K2 on the same rows laid out densely
(``kernel_checks.dense_decode_fn``). For ``decode_attention`` the old source
is likewise the first version's (pass the tree of a commit before K2 took
the split body), called without ``splits``. For both, each 16-bit case is
timed at every split S of ``SPLITS`` forced through the C entry, beside the
S the wrapper picks (``kernel_checks.case_splits``; ``[split]`` lines).
For ``flash_bwd_dq`` it also builds the new source without its near-tie
recompute of ds (``-DDS_FLASH_DQ_TIE_ULPS=0``), whose err/limit is printed
and may exceed 1. Exits non-zero if another version fails a case, or a build
fails.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

#: builds that show what a part of the kernel buys: reported, not failed
DIAGNOSTIC_BUILDS = {"flash_bwd_dq": [("no-tie-recompute", ["-DDS_FLASH_DQ_TIE_ULPS=0"])]}

#: the build-time macro that forces a wgmma kernel's block tiling
SWEEP_MACRO = {"flash_fwd": "DS_FLASH_FWD_WG", "flash_bwd_dq": "DS_FLASH_DQ_WG",
               "flash_bwd_dkv": "DS_FLASH_DKV_WG"}

_vp, _int = ctypes.c_void_p, ctypes.c_int
#: C entries whose argument list the current source changed: the old one
OLD_ARGTYPES = {"block_sparse_fwd": [
    _vp, _vp, _vp, _vp, _vp, _vp, _vp,       # q, k, v, idx, cnt, o, lse
    _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
    ctypes.c_float, _int, _int, _vp],        # scale, causal, dtype, stream
    "block_sparse_bwd_dq": [
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,  # q, k, v, do, lse, delta, idx, cnt
    _vp,                                     # dq
    _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
    ctypes.c_float, _int, _int, _vp],        # scale, causal, dtype, stream
    "block_sparse_bwd_dkv": [
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,  # q, k, v, do, lse, delta, idx, cnt
    _vp, _vp,                                # dk, dv
    _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
    ctypes.c_float, _int, _int, _vp],        # scale, causal, dtype, stream
    "quantized_matmul": [
    _vp, _vp, _vp, _vp, _vp,                 # x, q, scales, out (f32), work
    _int, _int, _int, _int, _int, _int,      # m, k, n, group, bits, chunk
    _int, _vp],                              # dtype, stream
    "paged_decode_attention": [
    _vp, _vp, _vp, _vp, _vp, _vp,            # q, k_pages, v_pages, table, lens, out
    _int, _int, _int, _int, _int, _int,      # b, h_kv, g, page, max_pages, d
    ctypes.c_float, _int, _vp],              # scale, dtype, stream
    "decode_attention": [
    _vp, _vp, _vp, _vp, _vp,                 # q, k_cache, v_cache, lens, out
    _int, _int, _int, _int, _int,            # b, h_kv, g, T, d
    ctypes.c_float, _int, _vp]}              # scale, dtype, stream


def old_skinny_split(m: int, k: int, n: int, bits: int):
    """``(chunk, splits)`` of the old wrapper: at m <= 16 a skinny pass split
    along the payload rows in chunks of 8, else the tiled pass, ``(0, 1)``."""
    if m > 16:
        return 0, 1
    prow = k if bits == 8 else k // 2
    cols = -(-(-(-n // 4)) // 128)
    splits = max(1, min(-(-4 * 132 // cols), prow // (8 * m), -(-prow // 32)))
    chunk = -(-(-(-prow // splits)) // 8) * 8
    return chunk, -(-prow // chunk)


def ptxas_report(nvcc_out: str):
    name = "?"
    for line in nvcc_out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1][:100]
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  {name}: {line.split(':', 1)[-1].strip()}")


def runner(kernel: str, fn, old: bool):
    """``run(case, inp)`` calling the C entry ``fn`` as the kernel's wrapper
    would (``old``: the old source's argument list), returning the wrapper's
    outputs."""
    import torch

    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.kernel_checks import _scale
    from deepspeed_tpu_torch.ops.quantizer import fused_matmul as fm

    def check(code, name):
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")

    def qmm(case, inp):
        x, q, s = inp["x"], inp["q"], inp["scales"]
        (m, k), (groups, n), bits = x.shape, s.shape, case.dims["bits"]
        stream = torch.cuda.current_stream().cuda_stream
        if old:
            out = torch.empty(m, n, dtype=torch.float32, device=x.device)
            chunk, splits = old_skinny_split(m, k, n, bits)
            work = torch.empty(splits, m, n, dtype=torch.float32, device=x.device) \
                if splits > 1 else out
            check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                     work.data_ptr(), m, k, n, k // groups, bits, chunk, DTYPE_CODES[x.dtype],
                     stream), kernel)
            return (out.to(x.dtype),)
        out = torch.empty(m, n, dtype=x.dtype, device=x.device)
        plan = fm.qmm_plan(m, k, n, k // groups, bits, x.dtype)
        work = torch.empty(plan.splits, m, n, dtype=torch.float32, device=x.device) \
            if plan.splits > 1 else out
        check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), None, out.data_ptr(),
                 work.data_ptr(), m, k, n, k // groups, bits, plan.tile_m, plan.chunk,
                 DTYPE_CODES[x.dtype], int(x.dtype == torch.float32), stream), kernel)
        return (out,)

    def flash(case, inp):
        q, k, v = inp["q"], inp["k"], inp["v"]
        bh, t, d = q.shape
        slopes = inp.get("slopes")
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        tail = (bh, t, d, case.dims["h"], _scale(case), int(case.causal), DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
        sp = None if slopes is None else slopes.data_ptr()
        if kernel == "flash_fwd":
            o = torch.empty_like(q)
            lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
            check(fn(*head, sp, o.data_ptr(), lse.data_ptr(), *tail), kernel)
            return o, lse
        bwd = (inp["do"].data_ptr(), inp["lse"].data_ptr(), inp["delta"].data_ptr(), sp)
        if kernel == "flash_bwd_dq":
            dq = torch.empty_like(q)
            check(fn(*head, *bwd, dq.data_ptr(), *tail), kernel)
            return (dq,)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check(fn(*head, *bwd, dk.data_ptr(), dv.data_ptr(), *tail), kernel)
        return dk, dv

    def block_sparse(case, inp):
        q, k, v = inp["q"], inp["k"], inp["v"]
        bh, t, d = q.shape
        block, h = kc.case_block(case), case.dims["h"]
        if kernel == "block_sparse_fwd":
            table = "fwd"
            outs = (torch.empty_like(q), torch.empty(bh, t, dtype=torch.float32, device=q.device))
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        else:
            table = "fwd" if kernel == "block_sparse_bwd_dq" else "bwd"
            outs = ((torch.empty_like(q),) if table == "fwd" else
                    (torch.empty_like(k), torch.empty_like(v)))
            head = tuple(inp[n].data_ptr() for n in ("q", "k", "v", "do", "lse", "delta"))
        head += (inp[f"{table}_idx"].data_ptr(), inp[f"{table}_cnt"].data_ptr())
        tail = (_scale(case), int(case.causal), DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
        max_n = inp[f"{table}_idx"].shape[2]
        out_ptrs = tuple(x.data_ptr() for x in outs)
        if old:
            check(fn(*head, *out_ptrs, bh, t, d, h, block, max_n, *tail), kernel)
            return outs
        tiles = inp["tiles"]
        check(fn(*head, *(x.data_ptr() for x in tiles), *out_ptrs, bh, t, d, h, block, max_n,
                 tiles.idx.shape[2], *tail), kernel)
        return outs

    def decode(case, inp, splits=None):
        q = inp["q"]
        b, h, d = q.shape
        hk = inp["k"].shape[1]
        out = torch.empty_like(q)
        head = (q.data_ptr(), inp["k"].data_ptr(), inp["v"].data_ptr())
        if kernel == "paged_decode_attention":
            head += (inp["table"].data_ptr(), inp["lens"].data_ptr(), out.data_ptr(), b, hk,
                     h // hk, inp["k"].shape[2], inp["table"].shape[1], d, _scale(case))
        else:
            head += (inp["lens"].data_ptr(), out.data_ptr(), b, hk, h // hk,
                     inp["k"].shape[2], d, _scale(case))
        tail = (DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if old:
            check(fn(*head, *tail), kernel)
        else:
            check(fn(*head, splits or kc.case_splits(case), *tail), kernel)
        return (out,)

    return {"quantized_matmul": qmm, "block_sparse_fwd": block_sparse,
            "block_sparse_bwd_dq": block_sparse, "block_sparse_bwd_dkv": block_sparse,
            "paged_decode_attention": decode, "decode_attention": decode}.get(kernel, flash)


def err_ratio(kc, case, out, ref) -> float:
    """The case's largest err/limit, as ``kernel_checks.check`` forms it (the
    forward's o only, then its lse against ``LSE_TOLERANCE``)."""
    atol, rtol = case.tolerance()
    pairs = list(zip(out, ref))[:1] if case.kernel in kc.FWD_KERNELS else list(zip(out, ref))
    ratio = max(kc.err_ratio(a, b, atol, rtol) for a, b in pairs)
    if case.kernel in kc.FWD_KERNELS:
        ratio = max(ratio, kc.max_abs_err(out[1], ref[1]) / kc.LSE_TOLERANCE)
    return ratio


def main(kernel: str, old_source: str) -> int:
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops import op_builder

    if not torch.cuda.is_available():
        print("qmm_versions: no CUDA card", file=sys.stderr)
        return 2
    info = op_builder.KERNELS[kernel]
    new_source = os.path.join(op_builder.CSRC_DIR, info.source)
    old_include = op_builder.CSRC_DIR
    if os.path.isdir(old_source):        # a tree: its own source and headers
        old_include = os.path.join(old_source, "deepspeed_tpu_torch", "ops", "csrc")
        old_source = os.path.join(old_include, info.source)
    builds = [("old", old_source, ["-I", old_include]), ("new", new_source, [])]
    if kernel in SWEEP_MACRO:
        builds += [(f"wg{n}", new_source, [f"-D{SWEEP_MACRO[kernel]}={n}"]) for n in (1, 2)]
        builds.append(("no-setmaxnreg", new_source, ["-DDS_NO_SETMAXNREG"]))
    diagnostic = DIAGNOSTIC_BUILDS.get(kernel, [])
    builds += [(tag, new_source, flags) for tag, flags in diagnostic]
    os.makedirs(op_builder.build_dir(), exist_ok=True)
    procs = []
    for tag, src, extra in builds:       # one nvcc a build, all at once
        so = os.path.join(op_builder.build_dir(), f"versions_{kernel}_{tag}.so")
        procs.append((tag, src, so, subprocess.Popen(
            [op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    runs, fns = {}, {}
    for tag, src, so, proc in procs:
        out, _ = proc.communicate()
        print(f"[versions] {kernel} {tag} build rc {proc.returncode}: {src}")
        if proc.returncode:
            print(out[-4000:])
            return 1
        if tag not in ("wg1", "wg2"):
            ptxas_report(out)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, info.symbol)
        old = tag == "old" and kernel in OLD_ARGTYPES
        fn.argtypes = OLD_ARGTYPES[kernel] if old else info.argtypes
        fn.restype = ctypes.c_int
        runs[tag], fns[tag] = runner(kernel, fn, old), fn

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"[versions] {chip_smoke.nvidia_smi_line()}")
    failed = False
    for case in kc.CASES:
        if case.kernel != kernel:
            continue
        inp = kc.make_inputs(case, device)
        ref = kc.run_plain(case, inp)
        tags = [tag for tag in runs if tag in ("old", "new") or case.dtype != torch.float32]
        ratio = {tag: err_ratio(kc, case, runs[tag](case, inp), ref) for tag in tags}
        ms = {}
        for tag in ("old", "new", "new", "old"):
            ms.setdefault(tag, []).append(chip_smoke.time_ms(lambda: runs[tag](case, inp)))
        sweep = {tag: chip_smoke.time_ms(lambda: runs[tag](case, inp))
                 for tag in tags if tag not in ("old", "new")}
        lib = kc.library_fn(case, inp)
        lib_ms = "null" if lib is None else f"{chip_smoke.time_ms(lib):.4f}"
        if kernel == "paged_decode_attention":
            lib_ms += f"; K2 dense {chip_smoke.time_ms(kc.dense_decode_fn(case, inp)):.4f}"
        failed |= not all(r <= 1.0 for tag, r in ratio.items()
                          if tag not in dict(diagnostic))
        print(f"[versions] {kernel}/{case.name} {case.dims} {str(case.dtype)[6:]}: err/limit "
              + " ".join(f"{tag} {r:.3f}" for tag, r in ratio.items())
              + f"; ms old {ms['old'][0]:.4f} / {ms['old'][1]:.4f}, new {ms['new'][0]:.4f} / "
              f"{ms['new'][1]:.4f}" + "".join(f", {tag} {t:.4f}" for tag, t in sweep.items())
              + f"; library {lib_ms}; bound {kc.bound_ms(case)[0]:.4f}", flush=True)
        if kernel in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv") and (
                case.dtype != torch.float32):
            walk_tail(runs["new"], case, inp)
        if kernel in ("paged_decode_attention", "decode_attention") and (
                case.dtype != torch.float32):
            failed |= not split_sweep(runs["new"], case, inp, ref)
        del inp, ref
    if kernel == "quantized_matmul":
        regime_switch(fns["new"], device)
    return 1 if failed else 0


def walk_tail(run, case, inp) -> None:
    """The new K9 or K10 build on the case's tile tables, then on the same
    tables with every walk but the first launched (the longest) emptied: a
    ``[tail]`` line with the blocks, the stages of the longest and of the
    mean walk, and both times. Where the two times are close, the longest
    walk sets the kernel's time."""
    import chip_smoke
    from deepspeed_tpu_torch.ops.kernel_checks import case_block

    tiles = inp["tiles"]
    slots = 64 // min(case_block(case), 64)
    stages = (tiles.cnt.long() + slots - 1) // slots
    first = int(tiles.order[0])
    alone = tiles.cnt.clone().view(-1)
    keep = int(alone[first])
    alone.zero_()
    alone[first] = keep
    n_batch = case.dims["b"]
    full_ms = chip_smoke.time_ms(lambda: run(case, inp))
    solo = dict(inp, tiles=tiles._replace(cnt=alone.view_as(tiles.cnt)))
    solo_ms = chip_smoke.time_ms(lambda: run(case, solo))
    print(f"[tail] {case.name}: {stages.numel() * n_batch} blocks, stages a block max "
          f"{int(stages.max())} mean {float(stages.float().mean()):.2f}; kernel {full_ms:.4f} "
          f"ms, the longest walk alone ({n_batch} blocks) {solo_ms:.4f} ms", flush=True)


def split_sweep(run, case, inp, ref) -> bool:
    """The new K5 or K2 build at every split S of ``SPLITS`` on one case's
    inputs: a ``[split]`` line with each S's time and err/limit, and the S
    that the wrapper's rule picks (``cluster_split``). Returns whether every
    S passed the case's limit."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import kernel_checks as kc
    from deepspeed_tpu_torch.ops.attention.decode import SPLITS

    ms, ratio = {}, {}
    for s in SPLITS:
        ratio[s] = err_ratio(kc, case, run(case, inp, splits=s), ref)
        ms[s] = chip_smoke.time_ms(lambda: run(case, inp, splits=s))
    print(f"[split] {case.kernel}/{case.name}: "
          + ", ".join(f"S {s} {t:.4f} ms (err/limit {ratio[s]:.3f})" for s, t in ms.items())
          + f"; the rule picks {kc.case_splits(case)}", flush=True)
    return all(r <= 1.0 for r in ratio.values())


#: the rows of x at which the regime switch is timed, and its shapes (k, n, bits)
SWITCH_M = (1, 4, 8, 9, 12, 16, 17, 24, 32, 48, 64)
SWITCH_SHAPES = {"bloom7b-q_proj-int8": (4096, 4096, 8), "bloom7b-fc_out-int4": (16384, 4096, 4)}


def regime_switch(fn, device) -> None:
    """Times the new kernel at every bf16 tiling for each m of ``SWITCH_M``:
    ``[switch]`` lines with the tiling ``qmm_plan`` picks."""
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.quantizer import fused_matmul as fm
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, quantize_grouped

    gen = torch.Generator(device=device).manual_seed(0)
    for name, (k, n, bits) in SWITCH_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device=device) / float(k) ** 0.5
        q, s = quantize_grouped(w, 128, bits=bits)
        if bits == 4:
            q = pack_int4(q, s.shape[0])
        del w
        for m in SWITCH_M:
            x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
            out = torch.empty(m, n, dtype=torch.bfloat16, device=device)
            ms = {}
            for tile in fm.QMM_TILES:
                plan = fm.qmm_split(m, k, n, 128, bits, tile)
                work = torch.empty(plan.splits, m, n, device=device) if plan.splits > 1 else out

                def call():
                    fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), None, out.data_ptr(),
                       work.data_ptr(), m, k, n, 128, bits, plan.tile_m, plan.chunk,
                       DTYPE_CODES[torch.bfloat16], 0, torch.cuda.current_stream().cuda_stream)

                ms[tile] = chip_smoke.time_ms(call)
            pick = fm.qmm_plan(m, k, n, 128, bits, torch.bfloat16).tile_m
            print(f"[switch] {name} m {m}: " + ", ".join(f"tile {t} {v:.4f} ms"
                                                     for t, v in ms.items())
                  + f"; qmm_plan picks {pick}", flush=True)


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "quantized_matmul"
    sys.exit(main(name, sys.argv[2] if len(sys.argv) > 2 else
                  os.path.join(ROOT, "build", f"{name}_old.cu")))
