"""The port's CUDA kernels against their plain versions, on the card.

Runs the cases of ``deepspeed_tpu_torch/ops/kernel_checks.py`` (shapes and
tolerances shared with ``chip_smoke.py``). The kernels have no CPU mode, so
without a CUDA card each case skips; only the registry of planted faults is
checked against the sources everywhere. This file imports no JAX, so it also
runs on the card's machine, which has none; there ``tests/conftest.py``
(which imports JAX) is left out:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``.
Add ``-s`` to see each planted fault's ``err/limit``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import kernel_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", kernel_checks.CASES,
                         ids=lambda c: f"{c.kernel}-{c.name}")
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kernel_checks.check(case, torch.device("cuda", 0))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_flash_fwd_refuses_autograd_on_card():
    """The forward kernel's output has no autograd history, so the wrapper
    refuses inputs that require grad while grad mode is on."""
    from deepspeed_tpu_torch.ops.attention.flash import flash_fwd
    q = torch.randn(4, 128, 64, device=_card(), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="FlashAttnFunction"):
        flash_fwd(q, q, q)
    with torch.no_grad():
        flash_fwd(q, q, q)


def test_flash_attention_gradients_on_card():
    """flash_attention on the card (forward kernel, then both backward
    kernels through FlashAttnFunction) against flash_bwd_plain fed with the
    forward kernel's o and lse on the same inputs, bf16, within the backward
    kernels' bf16 tolerance. The plain forward rounds o to bf16 at other
    points, and delta = rowsum(do * o) would carry that into every ds."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.flash import (flash_attention, flash_bwd_plain,
                                                         flash_fwd)
    device = _card()
    b, t, h, d = 2, 300, 4, 64
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    op_builder.reset_launch_counts()
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    counts = op_builder.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1)

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    q3, k3, v3, do3 = map(to3, (q, k, v, do))
    with torch.no_grad():
        o3, lse = flash_fwd(q3, k3, v3, None, None, True, h)
    want = flash_bwd_plain(q3, k3, v3, o3, lse, do3, None, d ** -0.5, True, h)
    atol, rtol = kernel_checks.BWD_TOLERANCES[torch.bfloat16]
    for g, w in zip(got, want):
        ratio = kernel_checks.err_ratio(to3(g), w, atol, rtol)
        assert ratio <= 1.0, ratio


def test_flash_head_dims_on_card():
    """The flash forward serves head_dim 256 (its 256-wide build) and refuses
    it under autograd, and refuses d 84 (not a multiple of 8), with a
    ValueError naming the head_dim, before any launch; the backward kernels
    refuse d 256."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.flash import flash_attention, flash_bwd, flash_fwd
    device = _card()
    x = torch.randn(1, 130, 2, 256, device=device, dtype=torch.bfloat16)
    op_builder.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for _ in range(3)]
    with pytest.raises(ValueError, match="head_dim 256 .* training"):
        flash_attention(*leaves)
    q84 = torch.zeros(2, 64, 84, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 84"):
        flash_fwd(q84, q84, q84)
    q3 = x.transpose(1, 2).reshape(2, 130, 256).contiguous()
    rows = torch.zeros(2, 130, device=device)
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_bwd(q3, q3, q3, q3, rows, q3)
    assert not any(op_builder.launch_counts().values())
    with torch.no_grad():
        o = flash_attention(x, x, x)
    assert op_builder.launch_counts()["flash_fwd"] == 1 and bool(torch.isfinite(o).all())


def test_refused_launch_raises():
    """A launch the entry point refuses (more than 65535 row blocks) comes back
    as a CUDA error code and is raised, never dropped."""
    from deepspeed_tpu_torch.ops.attention.flash import flash_bwd_dkv, flash_bwd_dq
    from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
    device = _card()
    q = torch.zeros(65536, 1, 64, device=device, dtype=torch.bfloat16)
    rows = torch.zeros(65536, 1, device=device)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(KernelLaunchError, match="invalid argument"):
            fn(q, q, q, q, rows, rows)


def test_paged_kernel_zero_length_slot_and_launch_count():
    """A slot with cache_len 0 gets zeros from the paged kernel (the TPU
    kernel's l_safe); the other slot matches the plain version; one launch."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    device = _card()
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(2, 4, 64, generator=gen, device=device).to(torch.bfloat16)
    pages = torch.randn(5, 4, 16, 64, generator=gen, device=device).to(torch.bfloat16)
    table = torch.tensor([[3, 1], [0, 0]], dtype=torch.int32, device=device)
    lens = torch.tensor([20, 0], dtype=torch.int32, device=device)
    op_builder.reset_launch_counts()
    out = paged_attention(q, pages, pages, table, lens, 32)
    assert op_builder.launch_counts()["paged_decode_attention"] == 1
    assert bool((out[1] == 0).all())
    ref = paged_attention_plain(q, pages, pages, table, lens, 32, 0.125)
    atol, rtol = kernel_checks.DECODE_TOLERANCES[torch.bfloat16]
    assert kernel_checks.err_ratio(out[:1], ref[:1], atol, rtol) <= 1.0


def test_kernel_repeats_bit_identical():
    """The dense and paged decode kernels merge their partials in a fixed
    order (lane groups, warps, then the cluster's blocks by rank) with no
    atomics, and so does the selected-expert FFN (warps and row groups in
    order, then the f-blocks' partials in a fixed order): two calls on the
    same inputs give the same bits, at every case's split and plan. Before
    the second call NaN fills the memory its output will take, so an output
    left unwritten shows."""
    device = _card()
    for case in kernel_checks.CASES:
        if case.kernel not in ("decode_attention", "paged_decode_attention", "moe_decode_ffn"):
            continue
        inp = kernel_checks.make_inputs(case, device)
        first = kernel_checks.run_kernel(case, inp)[0]
        poison = torch.full_like(first, float("nan"))
        del poison
        assert torch.equal(first, kernel_checks.run_kernel(case, inp)[0]), \
            (case.kernel, case.name)


def test_paged_kernel_page_one_long_cap():
    """Page size 1 under a 60000-entry table: the kernel reads only a slot's
    live entries and its shared memory does not grow with the table, so it
    launches at any cap. Rows are scattered over the pool in random order."""
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    device = _card()
    gen = torch.Generator(device=device).manual_seed(1)
    b, h, hk, d, mp, pool = 2, 4, 2, 128, 60000, 5000
    q = torch.randn(b, h, d, generator=gen, device=device).to(torch.bfloat16)
    kp, vp = (torch.randn(pool, hk, 1, d, generator=gen, device=device).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor([4000, 1234], dtype=torch.int32, device=device)
    table = torch.zeros(b, mp, dtype=torch.int32, device=device)
    for i, n in enumerate(lens.tolist()):
        table[i, :n] = torch.randperm(pool - 1, generator=gen, device=device)[:n].int() + 1
    out = paged_attention(q, kp, vp, table, lens, mp)
    ref = paged_attention_plain(q, kp, vp, table, lens, mp, d ** -0.5)
    atol, rtol = kernel_checks.DECODE_TOLERANCES[torch.bfloat16]
    assert kernel_checks.err_ratio(out, ref, atol, rtol) <= 1.0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantization_on_card_equals_cpu(bits):
    """A matrix quantized on the card has the payload and scales, byte for
    byte, that the CPU (and so the JAX package) gives it."""
    from deepspeed_tpu_torch.ops.quantizer import quantize_with_audit
    device = _card()
    w = (torch.randn(512, 384, generator=torch.Generator().manual_seed(bits)) / 20).bfloat16()
    on_card, _ = quantize_with_audit(w.to(device), bits=bits, group_size=128, threshold=1.0,
                                     name="w")
    on_cpu, _ = quantize_with_audit(w, bits=bits, group_size=128, threshold=1.0, name="w")
    for key, v in on_cpu.items():
        assert on_card[key].cpu().numpy().tobytes() == v.numpy().tobytes(), key


def test_quantized_matmul_launch_count_and_refusals():
    """Each call of the dequant-GEMM wrapper on the card is one launch, in
    every tiling and width, with or without a bias, in x's dtype or f32, and
    with a payload that is a view at an odd offset (no TMA map: plain loads);
    each matches the plain version; a shape it refuses raises before
    launching, and an argument the C entry refuses comes back as a CUDA error,
    raised."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
    from deepspeed_tpu_torch.ops.quantizer import (pack_int4, quantize_grouped,
                                                   quantized_matmul, quantized_matmul_plain)
    from deepspeed_tpu_torch.ops.quantizer.fused_matmul import QUANTIZED_MATMUL
    device = _card()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(64, 256, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(256, 96, generator=gen, device=device) / 16
    q8, s = quantize_grouped(w, 64)
    q4 = pack_int4(quantize_grouped(w, 64, bits=4)[0], s.shape[0])
    bias = torch.randn(96, generator=gen, device=device)
    odd = torch.empty(q8.numel() + 1, dtype=torch.int8, device=device)[1:].view_as(q8)
    odd.copy_(q8)
    op_builder.reset_launch_counts()
    calls = [(x[:1], q8, 8, {}), (x[:16], q8, 8, {}), (x, q8, 8, {}), (x[:3], q4, 4, {}),
             (x, q4, 4, {}), (x[:1], q8, 8, {"_bias": bias}), (x, q4, 4, {"_bias": bias}),
             (x[:9], q8, 8, {"out_dtype": torch.float32, "_bias": bias}),
             (x[:2], odd, 8, {}), (x, odd, 8, {"_bias": bias})]
    for i, (xi, q, bits, kw) in enumerate(calls):
        y = quantized_matmul(xi, q, s, bits=bits, **kw)
        assert op_builder.launch_counts()["quantized_matmul"] == i + 1
        ref = quantized_matmul_plain(xi, q, s, bits=bits, **kw)
        assert y.dtype == ref.dtype
        assert kernel_checks.err_ratio(y, ref, *kernel_checks.QMM_TOLERANCES[x.dtype]) <= 1.0
    with pytest.raises(ValueError, match="payload"):
        quantized_matmul(x, q8[:128], s, bits=8)
    with pytest.raises(ValueError, match="even group"):
        quantized_matmul(x[:, :6], torch.zeros(3, 96, dtype=torch.int8, device=device),
                         torch.ones(2, 96, device=device), bits=4)
    assert op_builder.launch_counts()["quantized_matmul"] == len(calls)
    out = torch.empty(17, 96, device=device)
    with pytest.raises(KernelLaunchError, match="invalid argument"):
        # a bf16 tiling of 17 rows, which the kernel does not have
        QUANTIZED_MATMUL.launch(x.data_ptr(), q8.data_ptr(), s.data_ptr(), None, out.data_ptr(),
                                out.data_ptr(), 17, 256, 96, 64, 8, 17, 0, 2, 0,
                                torch.cuda.current_stream(device).cuda_stream)


def test_moe_decode_ffn_block_widths_launch_count_and_refusals():
    """The selected-expert FFN on the card: the slab kernel at every f-block
    width the C entry takes, and the tensor-core kernel at its widths (8, 16
    and 32), give the plain version's result (a ragged last block at most of them), repeated
    calls are bit-identical (no atomics), each wrapper call counts one
    launch whatever n and k, and what the wrapper or the C entry refuses
    raises."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.flash import DTYPE_CODES
    from deepspeed_tpu_torch.ops.moe import moe_decode_ffn, moe_decode_ffn_plain
    from deepspeed_tpu_torch.ops.moe.decode_ffn import ACT_CODES, MMA, MOE_DECODE_FFN, SLAB
    from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
    device = _card()
    case = kernel_checks.Case("moe_decode_ffn", "widths", dict(n=6, e=4, d=256, f=1000, k=2),
                              torch.bfloat16)
    inp = kernel_checks.make_inputs(case, device)
    args = (inp["x"], inp["idx"], inp["w1"], inp["b1"], inp["w2"], inp["b2"], "gelu")
    ref = moe_decode_ffn_plain(*args)
    tol = kernel_checks.MOE_TOLERANCES[torch.bfloat16]
    stream = torch.cuda.current_stream(device).cuda_stream

    def direct(bf, mode):
        part = torch.empty(6, -(-1000 // bf), 256, device=device)
        y = torch.empty(6, 256, device=device)
        MOE_DECODE_FFN.launch(*(t.data_ptr() for t in args[:6]), part.data_ptr(), y.data_ptr(),
                              6, 256, 1000, 4, bf, mode, ACT_CODES["gelu"],
                              DTYPE_CODES[torch.bfloat16], stream)
        return y

    op_builder.reset_launch_counts()
    widths = (1, 7, 16, 32, 64, 128, 256)
    for bf in widths:
        y = moe_decode_ffn(*args, block_f=bf)
        assert kernel_checks.err_ratio(y, ref, *tol) <= 1.0, bf
        assert torch.equal(y, moe_decode_ffn(*args, block_f=bf)), bf
    assert op_builder.launch_counts()["moe_decode_ffn"] == 2 * len(widths)
    for bf in (8, 16, 32):
        y = direct(bf, MMA)
        assert kernel_checks.err_ratio(y, ref, *tol) <= 1.0, bf
        assert torch.equal(y, direct(bf, MMA)), bf
    with pytest.raises(ValueError, match="block_f"):
        moe_decode_ffn(*args, block_f=512)
    with pytest.raises(ValueError, match="w2"):
        moe_decode_ffn(*args[:4], inp["w2"][:, :-1], *args[5:])
    with pytest.raises(TypeError, match="share one"):
        moe_decode_ffn(args[0].float(), *args[1:])
    assert op_builder.launch_counts()["moe_decode_ffn"] == 2 * len(widths) + 6
    # the C entry: a width past 256; a mode it does not have; the
    # tensor-core kernel at a width it has no tiling for, on f32, or at a d
    # whose shared memory does not fit a block (its maps not yet made)
    for d, bf, mode, dtype in ((256, 300, SLAB, torch.bfloat16), (256, 16, 2, torch.bfloat16),
                               (256, 24, MMA, torch.bfloat16), (256, 16, MMA, torch.float32),
                               (4096, 16, MMA, torch.bfloat16)):
        with pytest.raises(KernelLaunchError, match="invalid argument"):
            MOE_DECODE_FFN.launch(*(t.data_ptr() for t in args[:6]), 0, 0, 6, d, 1000, 4, bf,
                                  mode, ACT_CODES["gelu"], DTYPE_CODES[dtype], stream)


def test_moe_decode_ffn_call_is_the_ffn_and_its_reduction():
    """A K7 call on the card launches the FFN kernel and the reduction and
    nothing else (no copy, no fill, no host synchronisation), at the plans of
    generate (one token, the tensor-core kernel), the scheduler (16 tokens,
    the slab kernel) and one token at GPT-2 6.7B's width (the slab kernel)."""
    from deepspeed_tpu_torch.ops.moe import moe_decode_ffn
    device = _card()
    for name in ("gpt2moe-decode-n1", "gpt2moe-serve-n16", "gpt2-6.7b-moe-n1"):
        case = next(c for c in kernel_checks.CASES if c.name == name)
        inp = kernel_checks.make_inputs(case, device)
        args = (inp["x"], inp["idx"], inp["w1"], inp["b1"], inp["w2"], inp["b2"], "gelu")
        moe_decode_ffn(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            moe_decode_ffn(*args)
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        ffn = "moe_ffn_mma" if name == "gpt2moe-decode-n1" else "moe_ffn_slab"
        assert len(kernels) == 2, (name, kernels)
        assert sum(ffn in k for k in kernels) == 1, (name, kernels)
        assert sum("moe_ffn_reduce" in k for k in kernels) == 1, (name, kernels)


def test_moe_decode_ffn_builds_do_not_spill():
    """``-Xptxas -v`` of the selected-expert FFN's source: no kernel (the
    tensor-core kernel, the slab kernel, the reduction, every dtype and
    vector width) spills or keeps a stack frame."""
    _card()
    from deepspeed_tpu_torch.ops import op_builder
    src = op_builder.KERNELS["moe_decode_ffn"].source
    out_dir = os.path.join(REPO, "build", "ptxas_check")
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           os.path.join(out_dir, src + ".so"),
                           os.path.join(op_builder.CSRC_DIR, src)],
                          capture_output=True, text=True, check=True)
    spills, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            spills[entry] = line.split(":", 1)[-1].strip()
    for kernel in ("moe_ffn_mma", "moe_ffn_slab", "moe_ffn_reduce"):
        assert any(kernel in e for e in spills), (kernel, list(spills))
    for e, v in spills.items():
        print(f"[ptxas] {src} {e[:90]}: {v}")
        assert v == "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", (e, v)


def _sparse_inputs(device, dtype, b=2, t=256, h=4, d=64, block=16):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=device).to(dtype)
                   for _ in range(4))
    layout = FixedSparsityConfig(h, block, different_layout_per_head=True, num_local_blocks=4,
                                 attention="unidirectional",
                                 num_different_global_patterns=4).make_layout(t)
    return q, k, v, do, layout


def test_block_sparse_attention_gradients_and_launches_on_card():
    """block_sparse_attention on the card (the forward kernel, then both
    backward kernels through BlockSparseAttnFunction): one launch of each, o
    within the forward's bf16 limit of the plain forward, and dq, dk, dv
    within the backward's of the plain backward fed with the forward kernel's
    o and lse; the forward kernel refuses inputs that require grad under
    grad mode, and all three kernels bf16 inputs without their tile
    tables."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention import block_sparse as bs
    device = _card()
    q, k, v, do, layout = _sparse_inputs(device, torch.bfloat16)
    b, t, h, d = q.shape
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    op_builder.reset_launch_counts()
    o = bs.block_sparse_attention(*leaves, layout, 16, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    counts = op_builder.launch_counts()
    assert [counts[n] for n in kernel_checks.BS_KERNELS] == [1, 1, 1]
    assert counts["flash_fwd"] == 0

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    q3, k3, v3, do3 = map(to3, (q, k, v, do))
    tables = bs.device_tables(bs.build_tables(layout), device)
    tiles = bs.kernel_tile_tables(layout, 16, device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="tile tables"):
            bs.block_sparse_fwd(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"], 16,
                                causal=True, n_heads=h)
        o3, lse = bs.block_sparse_fwd(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"], 16,
                                      causal=True, n_heads=h, tiles=tiles)
    want_o, _ = bs.block_sparse_fwd_plain(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"],
                                          16, d ** -0.5, True, h)
    assert kernel_checks.err_ratio(to3(o.detach()), want_o,
                                   *kernel_checks.FWD_TOLERANCES[torch.bfloat16]) <= 1.0
    delta = (do3.float() * o3.float()).sum(-1)
    want = (bs.block_sparse_bwd_dq_plain(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                                         tables["fwd_cnt"], 16, d ** -0.5, True, h),
            *bs.block_sparse_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                           tables["bwd_cnt"], 16, d ** -0.5, True, h))
    atol, rtol = kernel_checks.BWD_TOLERANCES[torch.bfloat16]
    for g, w in zip(got, want):
        assert kernel_checks.err_ratio(to3(g), w, atol, rtol) <= 1.0
    with pytest.raises(ValueError, match="tile tables"):
        bs.block_sparse_bwd_dq(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                               tables["fwd_cnt"], 16, causal=True, n_heads=h)
    with pytest.raises(ValueError, match="tile tables"):
        bs.block_sparse_bwd_dkv(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                tables["bwd_cnt"], 16, causal=True, n_heads=h)
    with pytest.raises(ValueError, match="BlockSparseAttnFunction"):
        bs.block_sparse_fwd(to3(leaves[0]), k3, v3, tables["fwd_idx"], tables["fwd_cnt"], 16,
                            n_heads=h)


@pytest.mark.parametrize("policy", ["dots", "offload_dots"])
def test_gpt2_remat_launches_and_gradients_on_card(policy):
    """A tiny GPT-2 (head_dim 64, 2 layers, seq 256, bf16) on the card: the
    loss and every gradient of one micro-batch under remat ("dots";
    "offload_dots", which keeps dots' products in pinned host memory) equal
    the no-remat ones bit for bit; K1 launches 2 a step without remat
    and 4 with it (the backward runs each block's forward again), K3 and K4
    2 either way."""
    import dataclasses

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import op_builder
    device = _card()
    base = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128, n_layer=2, n_head=2)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 256))).to(device)

    def step(cfg):
        params = {k: v.requires_grad_() for k, v in gpt2.init_params(cfg, 0, device).items()}
        op_builder.reset_launch_counts()
        loss = gpt2.gpt2_model(cfg).loss_fn({k: p.to(torch.bfloat16) for k, p in params.items()},
                                            {"input_ids": ids})
        grads = torch.autograd.grad(loss, list(params.values()))
        counts = op_builder.launch_counts()
        kernels = ("flash_fwd",) + kernel_checks.BWD_KERNELS
        return loss.detach(), grads, [counts[n] for n in kernels]

    want = step(base)
    got = step(dataclasses.replace(base, remat=True, remat_policy=policy))
    assert want[2] == [2, 2, 2] and got[2] == [4, 2, 2], (want[2], got[2])
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_block_sparse_refuses_unsupported_shapes_on_card():
    """A head_dim or layout block the kernels do not take raises ValueError
    before any launch, and does not fall back (d 84, not a multiple of 8; d
    256, above the training kernels' 128; block 8); an argument the C entry
    refuses comes back as a CUDA error, raised."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention import block_sparse as bs
    from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
    device = _card()
    layout = np.ones((2, 8, 8), np.int64)
    op_builder.reset_launch_counts()
    for d, block in ((84, 16), (64, 8), (256, 16)):
        t = 8 * block
        q = torch.zeros(2, t, 2, d, device=device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim|layout block"):
            bs.block_sparse_attention(q, q, q, layout, block, causal=True)
    assert not any(op_builder.launch_counts()[n] for n in kernel_checks.BS_KERNELS)
    q3 = torch.zeros(4, 128, 64, device=device, dtype=torch.bfloat16)
    tables = bs.device_tables(bs.build_tables(layout), device)
    tiles = bs.build_tile_tables(layout, 16).to(device)
    lse = torch.empty(4, 128, device=device)
    with pytest.raises(KernelLaunchError, match="invalid argument"):
        # n_heads 3 does not divide b*h 4
        bs.BLOCK_SPARSE_FWD.launch(q3.data_ptr(), q3.data_ptr(), q3.data_ptr(),
                                   tables["fwd_idx"].data_ptr(), tables["fwd_cnt"].data_ptr(),
                                   *(x.data_ptr() for x in tiles), q3.data_ptr(),
                                   lse.data_ptr(), 4, 128, 64, 3, 16, 8,
                                   tiles.idx.shape[2], 0.125, 1, 2,
                                   torch.cuda.current_stream(device).cuda_stream)


#: the selected-expert FFN's check cases that its plan runs on the tensor
#: cores (test_moe_plan_at_the_check_cases holds the list to the plan)
MOE_MMA_CASES = ("moe_decode_ffn:gpt2moe-decode-n1", "moe_decode_ffn:gpt2moe-top2-n2",
                 "moe_decode_ffn:dsmoe350m-e128-n1", "moe_decode_ffn:ragged-d96-f200-n1-relu")

#: faults planted in a copy of the package: name -> (source in csrc/, line as
#: written, line as planted, the check cases the fault must fail, as
#: selectors of ``kernel_checks.selects``: "kernel" every case of a kernel,
#: "kernel:tag:..." its cases with every tag, e.g. "quantized_matmul:int4",
#: "flash_bwd_dkv:bfloat16:causal" or, by name,
#: "block_sparse_fwd:bigbird16-causal")
PLANTED_FAULTS = {
    "decode-skips-last-tile": (
        "decode_attention.cu",
        "const int len = min(max(lens[bi], 0), cap);",
        "const int len = (min(max(lens[bi], 0), cap) - 1) / STAGE_ROWS * STAGE_ROWS;",
        ("decode_attention",)),
    # every K2 case has a sequence shorter than its capacity, whose rows past
    # cache_len hold 1e4
    "decode-rows-past-len-read": (
        "decode_attention.cu",
        "const int len = min(max(lens[bi], 0), cap);",
        "const int len = cap;",
        ("decode_attention",)),
    "decode-o-5pct-high": (
        "decode_split.cuh",
        "out[e] = from_f32<T>(ls > 0.f ? a / ls : 0.f);",
        "out[e] = from_f32<T>(ls > 0.f ? 1.05f * a / ls : 0.f);",
        ("decode_attention",)),
    "paged-skips-last-live-page": (
        "paged_decode_attention.cu",
        "const int last = npg > 0 ? (len - (npg - 1) * page + STAGE_ROWS - 1) / STAGE_ROWS : 0;",
        "const int last = 0;",
        ("paged_decode_attention",)),
    "paged-o-5pct-high": (
        "decode_split.cuh",
        "out[e] = from_f32<T>(ls > 0.f ? a / ls : 0.f);",
        "out[e] = from_f32<T>(ls > 0.f ? 1.05f * a / ls : 0.f);",
        ("paged_decode_attention",)),
    # rank 0's partial, which every sequence with rows has, whatever S
    "paged-merge-drops-a-split": (
        "decode_split.cuh",
        "if (r < splits) {",
        "if (r > 0 && r < splits) {",
        ("paged_decode_attention", "decode_attention")),
    # K2's tiles stop at cache_len (DenseUnits::rows), so only the paged
    # kernel copies rows past it, for this mask to exclude
    "paged-rows-past-len-unmasked": (
        "decode_split.cuh",
        "const int nvalid = min(stage_rows(s), len - first);",
        "const int nvalid = stage_rows(s);",
        # every case with a slot whose last live page is partly past its length
        ("paged_decode_attention:gpt2-serve", "paged_decode_attention:gqa-d128",
         "paged_decode_attention:fp32-gqa-page8-cap300", "paged_decode_attention:bf16-page5-d128",
         "paged_decode_attention:bf16-gqa-empty-slot", "paged_decode_attention:qwen2-g7-d128")),
    "paged-empty-slot-skips-zero-write": (
        "decode_split.cuh",
        "out[e] = from_f32<T>(ls > 0.f ? a / ls : 0.f);",
        "if (ls > 0.f) out[e] = from_f32<T>(a / ls);",
        ("paged_decode_attention:bf16-gqa-empty-slot", "decode_attention:bf16-gqa-empty-slot")),
    "flash-fwd-o-5pct-high": (
        "flash_fwd.cu",
        "o[off + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);",
        "o[off + tx + 16 * c] = from_f32<T>(1.05f * acc[i][c] / l_safe);",
        ("flash_fwd:float32",)),
    "flash-fwd-wgmma-o-5pct-high": (
        "flash_fwd.cu",
        "pack2<T>(lo, hi);",
        "pack2<T>(1.05f * lo, 1.05f * hi);",
        ("flash_fwd:bfloat16", "flash_fwd:float16")),
    "flash-dq-f32-5pct-high": (
        "flash_bwd_dq.cu",
        "dq[off + tx + 16 * c] = from_f32<T>(acc[i][c]);",
        "dq[off + tx + 16 * c] = from_f32<T>(1.05f * acc[i][c]);",
        ("flash_bwd_dq:float32",)),
    "flash-dq-wgmma-5pct-high": (
        "flash_bwd_dq.cu",
        "pack2<T>(acc[p][a], acc[p][a + 1]);",
        "pack2<T>(1.05f * acc[p][a], 1.05f * acc[p][a + 1]);",
        ("flash_bwd_dq:bfloat16", "flash_bwd_dq:float16")),
    "flash-dq-drops-last-kv-tile": (
        "flash_bwd_dq.cu",
        "const int nk_all = (t + BK - 1) / BK;",
        "const int nk_all = (t + BK - 1) / BK - 1;",
        ("flash_bwd_dq:bfloat16", "flash_bwd_dq:float16")),
    "flash-dq-skips-diagonal-mask": (
        "flash_bwd_dq.cu",
        "const bool mask_causal = causal && k0 + BK - 1 > row0;",
        "const bool mask_causal = false;",
        ("flash_bwd_dq:bfloat16:causal", "flash_bwd_dq:float16:causal")),
    "flash-dkv-drops-last-q-tile": (
        "flash_bwd_dkv.cu",
        "const int q_end = nq;",
        "const int q_end = nq - 1;",
        ("flash_bwd_dkv:bfloat16", "flash_bwd_dkv:float16")),
    "flash-dkv-skips-diagonal-mask": (
        "flash_bwd_dkv.cu",
        "const bool mask_causal = causal && q0 < kv0 + 64;",
        "const bool mask_causal = false;",
        ("flash_bwd_dkv:bfloat16:causal", "flash_bwd_dkv:float16:causal")),
    "qmm-skips-last-group": (
        "quantized_matmul.cu",
        "const int k_used = k;",
        "const int k_used = k - group;",
        ("quantized_matmul",)),
    # the reduction, after either FFN kernel
    "moe-skips-last-f-block": (
        "moe_decode_ffn.cu",
        "const int nfb_used = nfb;",
        "const int nfb_used = nfb - 1;",
        ("moe_decode_ffn",)),
    "moe-adds-b2-twice": (
        "moe_decode_ffn.cu",
        "float v = to_f32(b2[(size_t)ex * d + col]);",
        "float v = 2.f * to_f32(b2[(size_t)ex * d + col]);",
        ("moe_decode_ffn",)),
    "moe-reduce-skips-first-f-block": (
        "moe_decode_ffn.cu",
        "for (int j = g; j < nfb_used; j += RED_GROUPS) s += __ldcg(p + (size_t)j * d);",
        "for (int j = g + (g == 0) * RED_GROUPS; j < nfb_used; j += RED_GROUPS) "
        "s += __ldcg(p + (size_t)j * d);",
        ("moe_decode_ffn",)),
    # the tensor-core kernel: the cases its plan takes it for (one or two
    # tokens)
    "moe-mma-w2-unswizzled": (
        "moe_decode_ffn.cu",
        "(((nt & 7) ^ (r & 7)) << 4)),",
        "((nt & 7) << 4)),",
        MOE_MMA_CASES),
    "moe-mma-h-drops-last-warp": (
        "moe_decode_ffn.cu",
        "for (int w = 0; w < WARPS; ++w) s += red[w * p.bf + c];",
        "for (int w = 0; w < WARPS - 1; ++w) s += red[w * p.bf + c];",
        MOE_MMA_CASES),
    "qmm-wgmma-drops-a-stage": (
        "quantized_matmul.cu",
        "const int n_st = max(p_end - p_begin + PR - 1, 0) / PR;",
        "const int n_st = max(p_end - p_begin + PR - 1, 0) / PR - 1;",
        ("quantized_matmul:bfloat16", "quantized_matmul:float16")),
    "qmm-high-nibble-unsigned": (
        "quantized_matmul.cu",
        "__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }",
        "__device__ __forceinline__ int nib_hi(int b) { return (b & 0xFF) >> 4; }",
        ("quantized_matmul:int4",)),
    "block-sparse-fwd-walk-stops-early": (
        "block_sparse_fwd.cu",
        "const int nnz = cnt[head * nb + qb];",
        "const int nnz = cnt[head * nb + qb] - 1;",
        ("block_sparse_fwd:float32",)),
    "block-sparse-fwd-wgmma-drops-ownership-mask": (
        "block_sparse_fwd.cu",
        "const bool own = (ej >> g) & 1;",
        "const bool own = true;",
        ("block_sparse_fwd:hand-made-empty-past-diagonal", "block_sparse_fwd:bigbird16-causal")),
    "block-sparse-fwd-wgmma-walk-stops-a-stage-early": (
        "block_sparse_fwd.cu",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots;",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots - 1;",
        ("block_sparse_fwd:bfloat16", "block_sparse_fwd:float16")),
    "block-sparse-fwd-wgmma-masked-as-excluded": (
        "block_sparse_fwd.cu",
        "x = !own ? excluded : (causal && col > row) ? DS_NEG_INF : x;",
        "x = !own ? excluded : (causal && col > row) ? excluded : x;",
        ("block_sparse_fwd:hand-made-empty-past-diagonal",)),
    "block-sparse-dq-skips-first-k-block": (
        "block_sparse_bwd_dq.cu",
        "for (int n = 0; n < nnz; ++n) {",
        "for (int n = 1; n < nnz; ++n) {",
        ("block_sparse_bwd_dq:float32",)),
    "block-sparse-dq-wgmma-walk-stops-a-stage-early": (
        "block_sparse_bwd_dq.cu",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots;",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots - 1;",
        ("block_sparse_bwd_dq:bfloat16", "block_sparse_bwd_dq:float16")),
    "block-sparse-dq-wgmma-drops-ownership-mask": (
        "block_sparse_bwd_dq.cu",
        "const bool own = (ej >> g) & 1;",
        "const bool own = true;",
        ("block_sparse_bwd_dq:gpt2-train-fixed16", "block_sparse_bwd_dq:bigbird16-causal")),
    "block-sparse-dq-wgmma-masked-as-excluded": (
        "block_sparse_bwd_dq.cu",
        "x = !own ? excluded : (causal && col > row) ? masked : x;",
        "x = !own ? excluded : (causal && col > row) ? excluded : x;",
        ("block_sparse_bwd_dq:hand-made-empty-past-diagonal",
         "block_sparse_bwd_dq:hand-made-block64")),
    "block-sparse-dq-wgmma-drops-lo-of-ds": (
        "block_sparse_bwd_dq.cu",
        "mma_rs<T, 1>(acc[p], ds_lo[kk], bk);",
        "(void)ds_lo;",
        ("block_sparse_bwd_dq:hand-made-empty-past-diagonal",
         "block_sparse_bwd_dq:hand-made-block64")),
    "block-sparse-dq-wgmma-empty-tile-skips-zero-write": (
        "block_sparse_bwd_dq.cu",
        "if (row < t) {",
        "if (row < t && n_st > 0) {",
        ("block_sparse_bwd_dq:hand-made-block64",)),
    "block-sparse-dkv-drops-last-q-block": (
        "block_sparse_bwd_dkv.cu",
        "const int nnz = cnt[head * nb + kb];",
        "const int nnz = cnt[head * nb + kb] - 1;",
        ("block_sparse_bwd_dkv:float32",)),
    "block-sparse-dkv-wgmma-walk-stops-a-stage-early": (
        "block_sparse_bwd_dkv.cu",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots;",
        "const int n_st = (tile_cnt[ht] + slots - 1) / slots - 1;",
        ("block_sparse_bwd_dkv:bfloat16", "block_sparse_bwd_dkv:float16")),
    "block-sparse-dkv-wgmma-drops-ownership-mask": (
        "block_sparse_bwd_dkv.cu",
        "const bool own = (ej >> g) & 1;",
        "const bool own = true;",
        ("block_sparse_bwd_dkv:bigbird16-causal",
         "block_sparse_bwd_dkv:hand-made-empty-past-diagonal",
         "block_sparse_bwd_dkv:gpt2-train-fixed16")),
    "block-sparse-dkv-wgmma-masked-as-excluded": (
        "block_sparse_bwd_dkv.cu",
        "x = !own ? excluded : (causal && col > row) ? masked : x;",
        "x = !own ? excluded : (causal && col > row) ? excluded : x;",
        ("block_sparse_bwd_dkv:hand-made-empty-past-diagonal",)),
    "block-sparse-dkv-wgmma-empty-tile-skips-zero-write": (
        "block_sparse_bwd_dkv.cu",
        "if (my_unit >= 0) {",
        "if (my_unit >= 0 && n_st > 0) {",
        ("block_sparse_bwd_dkv:hand-made-block64",)),
    # head dims other than 64 and 128 run on a wider build: a store past
    # column d writes the next row's first columns, and a row stride of the
    # build width D puts rows in the wrong places
    "flash-fwd-wgmma-stores-past-d": (
        "flash_fwd.cu",
        "if (PANEL * p + 8 * j >= d) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("flash_fwd:gpt2-2.7b-prefill", "flash_fwd:gpt2-760m-train")),
    "flash-fwd-wgmma-row-stride-D": (
        "flash_fwd.cu",
        "T* orow = o + ((size_t)bh * t + row) * d;",
        "T* orow = o + ((size_t)bh * t + row) * D;",
        ("flash_fwd:t130-d80",)),
    "flash-dq-wgmma-stores-past-d": (
        "flash_bwd_dq.cu",
        "if (PANEL * p + 8 * j >= d) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("flash_bwd_dq:gpt2-760m-train", "flash_bwd_dq:ragged-t1000-d80")),
    "flash-dq-wgmma-row-stride-D": (
        "flash_bwd_dq.cu",
        "T* dqrow = dq + ((size_t)bh * t + row) * d;",
        "T* dqrow = dq + ((size_t)bh * t + row) * D;",
        ("flash_bwd_dq:t130-d80",)),
    "flash-dkv-wgmma-stores-past-d": (
        "flash_bwd_dkv.cu",
        "if (PANEL * p + 8 * j >= dw) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("flash_bwd_dkv:gpt2-760m-train", "flash_bwd_dkv:ragged-t1000-d80")),
    "flash-dkv-wgmma-row-stride-D": (
        "flash_bwd_dkv.cu",
        "const size_t off = ((size_t)bh * t + row) * dw;",
        "const size_t off = ((size_t)bh * t + row) * D;",
        ("flash_bwd_dkv:t130-d80",)),
    "block-sparse-fwd-wgmma-stores-past-d": (
        "block_sparse_fwd.cu",
        "if (PANEL * p + 8 * j >= d) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("block_sparse_fwd:gpt2-760m-train-fixed16",)),
    "block-sparse-fwd-wgmma-row-stride-D": (
        "block_sparse_fwd.cu",
        "T* orow = o + ((size_t)bh * t + row) * d;",
        "T* orow = o + ((size_t)bh * t + row) * D;",
        ("block_sparse_fwd:gpt2-760m-train-fixed16",)),
    "block-sparse-dq-wgmma-stores-past-d": (
        "block_sparse_bwd_dq.cu",
        "if (PANEL * p + 8 * j >= d) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("block_sparse_bwd_dq:gpt2-760m-train-fixed16",)),
    "block-sparse-dq-wgmma-row-stride-D": (
        "block_sparse_bwd_dq.cu",
        "T* dqrow = dq + ((size_t)bh * t + row) * d;",
        "T* dqrow = dq + ((size_t)bh * t + row) * D;",
        ("block_sparse_bwd_dq:gpt2-760m-train-fixed16",)),
    "block-sparse-dkv-wgmma-stores-past-d": (
        "block_sparse_bwd_dkv.cu",
        "if (PANEL * p + 8 * j >= d) continue;",
        "if (PANEL * p + 8 * j >= D) continue;",
        ("block_sparse_bwd_dkv:gpt2-760m-train-fixed16",)),
    "block-sparse-dkv-wgmma-row-stride-D": (
        "block_sparse_bwd_dkv.cu",
        "const size_t off = ((size_t)bh * t + ka + 8 * i) * d;",
        "const size_t off = ((size_t)bh * t + ka + 8 * i) * D;",
        ("block_sparse_bwd_dkv:gpt2-760m-train-fixed16",)),
    "decode-split-stores-past-d": (
        "decode_split.cuh",
        "for (int e = rank * NTHREADS + tid; e < g_used * d; e += splits * NTHREADS) {",
        "for (int e = rank * NTHREADS + tid; e < g_used * D; e += splits * NTHREADS) {",
        ("decode_attention:gpt2-2.7b-decode", "paged_decode_attention:gpt2-2.7b-serve")),
    "decode-q-row-stride-D": (
        "decode_attention.cu",
        "const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * d;",
        "const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * D;",
        ("decode_attention:gpt2-2.7b-decode", "decode_attention:fp32-gqa-d96")),
    "paged-q-row-stride-D": (
        "paged_decode_attention.cu",
        "const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * d;",
        "const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * D;",
        ("paged_decode_attention:gpt2-2.7b-serve",)),
}

# run inside the planted copy, from the selected check case numbered argv[1]
# on: which package it imported and how many cases are selected, then
# err/limit of each case (a forward's o only: its lse limit does not see a
# scaled o). A non-finite output counts as caught, with an infinite
# err/limit, as ``kernel_checks.check`` fails it. So does a kernel that
# raises a CUDA error at launch or when the card is synchronized after it
# (such as an access out of bounds); the context may then be lost, so the
# child stops after that case and the test starts a new one at the next.
# Any other error, a build failure among them, fails the test.
_PLANTED_CHILD = """
import json, sys, torch
from deepspeed_tpu_torch.ops import kernel_checks as kc
from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
dev = torch.device("cuda", 0)
cases = [c for c in kc.CASES if any(kc.selects(sel, c) for sel in sys.argv[2:])]
print(json.dumps({"module": kc.__file__, "cases": len(cases)}), flush=True)
for case in cases[int(sys.argv[1]):]:
    name = f"{case.kernel}/{case.name}"
    inp = kc.make_inputs(case, dev)
    try:
        out = kc.run_kernel(case, inp)
        torch.cuda.synchronize()
    except RuntimeError as e:
        if not isinstance(e, KernelLaunchError) and "CUDA error" not in str(e):
            raise
        print(json.dumps({"case": name, "err_ratio": float("inf"),
                          "error": str(e).splitlines()[0][:200]}), flush=True)
        sys.exit(0)
    ref = kc.run_plain(case, inp)
    atol, rtol = case.tolerance()
    pairs = list(zip(out, ref))[:1] if case.kernel in kc.FWD_KERNELS else list(zip(out, ref))
    ratio = max(kc.err_ratio(a, b, atol, rtol) for a, b in pairs)
    if not all(bool(torch.isfinite(o.float()).all()) for o in out):
        ratio = float("inf")
    print(json.dumps({"case": name, "err_ratio": ratio}), flush=True)
"""


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_kernel_checks_fail_planted_fault(fault):
    """The kernel checks catch a wrong kernel. A copy of the package under
    ``build/planted/<fault>/`` gets one line of one kernel source changed and
    builds its own kernels into the copy's ``build/``; every check case of
    the kernels the fault reaches must then exceed its limit, each in a
    context no earlier case's CUDA error has lost. The package itself is
    never touched."""
    _card()
    source, line, planted, kernels = PLANTED_FAULTS[fault]
    work = os.path.join(REPO, "build", "planted", fault)
    shutil.rmtree(work, ignore_errors=True)
    pkg = os.path.join(work, "deepspeed_tpu_torch")
    shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "ops", "csrc", source)
    with open(path) as f:
        text = f.read()
    assert text.count(line) == 1, f"the line to plant is not once in {source}: {line}"
    with open(path, "w") as f:
        f.write(text.replace(line, planted))
    env = {k: v for k, v in os.environ.items() if k != "DS_TORCH_BUILD_DIR"}
    rows = []
    while True:
        proc = subprocess.run([sys.executable, "-c", _PLANTED_CHILD, str(len(rows)), *kernels],
                              cwd=work, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        first, *got = [json.loads(x) for x in proc.stdout.splitlines()]
        assert first["module"].startswith(pkg), first
        rows += got
        if not got or "error" not in got[-1] or len(rows) == first["cases"]:
            break
    assert rows and len(rows) == first["cases"], (first, rows)
    for row in rows:
        print(f"[fault] {fault} {row['case']}: err/limit {row['err_ratio']:.4g}"
              + (f" ({row['error']})" if "error" in row else ""))
    assert all(row["err_ratio"] > 1.0 for row in rows), rows


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_planted_fault_line_and_cases(fault):
    """Without a card: each planted fault's line stands exactly once in its
    source, and its selectors name at least one check case each, so the card
    test above plants what it says and checks something."""
    source, line, _, selectors = PLANTED_FAULTS[fault]
    with open(os.path.join(REPO, "deepspeed_tpu_torch", "ops", "csrc", source)) as f:
        assert f.read().count(line) == 1, f"the line to plant is not once in {source}: {line}"
    for sel in selectors:
        assert any(kernel_checks.selects(sel, c) for c in kernel_checks.CASES), sel


def test_moe_plan_at_the_check_cases():
    """Without a card: ``MOE_MMA_CASES`` names exactly the selected-expert
    FFN cases whose plan runs the tensor-core kernel, so that kernel's
    planted faults are held to the cases that run it."""
    from deepspeed_tpu_torch.ops.moe.decode_ffn import SLAB, moe_plan
    mma = set()
    for c in kernel_checks.CASES:
        if c.kernel == "moe_decode_ffn":
            itemsize = torch.tensor([], dtype=c.dtype).element_size()
            if moe_plan(c.dims["n"], c.dims["d"], c.dims["f"], itemsize)[1] != SLAB:
                mma.add(f"moe_decode_ffn:{c.name}")
    assert mma == set(MOE_MMA_CASES)


def test_case_selectors():
    """``kernel_checks.selects`` picks by kernel and by every tag given."""
    names = {sel: sorted(c.name for c in kernel_checks.CASES if kernel_checks.selects(sel, c))
             for sel in ("flash_fwd:float32", "flash_bwd_dkv:float16:full",
                         "quantized_matmul:int4:float32")}
    assert names == {"flash_fwd:float32": ["fp32", "fp32-d256", "fp32-d80"],
                     "flash_bwd_dkv:float16:full": ["fp16-full-d128"],
                     "quantized_matmul:int4:float32": []}
    every = [c for c in kernel_checks.CASES if kernel_checks.selects("flash_fwd", c)]
    assert every and all(c.kernel == "flash_fwd" for c in every)


#: consumer warpgroup tilings a block of each wgmma source's kernels: K1, K3
#: and K4 have one and two, K8, K9 and K10 one; K6 has one for each wgmma N
#: (8, 16, 128), and its wgmma functions are 2 dtypes x 2 bit widths x those
WGMMA_TILINGS = {"block_sparse_fwd.cu": 1, "block_sparse_bwd_dq.cu": 1,
                 "block_sparse_bwd_dkv.cu": 1, "quantized_matmul.cu": 3}
#: the sources whose wgmma kernels are built twice a width: for a head_dim
#: equal to it (the strides constant) and below it (the head_dim at run time)
EXACT_SOURCES = ("flash_fwd.cu", "flash_bwd_dkv.cu", "block_sparse_fwd.cu")
#: wgmma functions beside the 2 dtypes x 2 widths x tilings: those second
#: builds, and K1's 256-wide one (serving head dims 136 to 256; one tiling,
#: both builds)
WGMMA_EXTRA = {"flash_fwd.cu": 8 + 4, "flash_bwd_dkv.cu": 8, "block_sparse_fwd.cu": 4}
#: the one source whose 128-wide builds keep a stack frame: K3's 16 bytes,
#: which its head-dim-64 main-path builds have too
STACK_FRAMES = ("flash_bwd_dq.cu",)
#: the mangled-name mark of each wgmma source's main-path instantiations
#: (bf16; the flash kernels at head dim 64), and how many there are: K6's
#: main paths run every bf16 tiling at int8 and int4
MAIN_PATH = {"quantized_matmul.cu": ("13__nv_bfloat16L", 6)}


def _wgmma_libraries():
    """Builds K1's, K3's, K4's, K6's, K8's, K9's and K10's sources; their
    libraries' paths."""
    from deepspeed_tpu_torch.ops import op_builder
    sources = [op_builder.KERNELS[k].source for k in kernel_checks.WGMMA_KERNELS]
    op_builder.build(sources)
    return {src: op_builder._library_path(src) for src in sources}


def test_wgmma_kernels_issue_hgmma_and_tma_loads():
    """The bf16/fp16 kernels of K1, K3, K4, K6, K8, K9 and K10 run on the
    tensor cores through wgmma, fed by TMA: in the SASS of every ``wgmma_*`` function
    (2 dtypes x 2 build widths, or K6's 2 bit widths, x ``WGMMA_TILINGS``, and
    ``WGMMA_EXTRA``) stand
    HGMMA and UTMALDG; the first version's f32 kernels (and K6's split-k
    reduction), beside them, have neither."""
    _card()
    from deepspeed_tpu_torch.ops import op_builder
    cuobjdump = os.path.join(os.path.dirname(op_builder._nvcc()), "cuobjdump")
    for src, lib in _wgmma_libraries().items():
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        functions = sass.split("Function : ")[1:]
        wgmma = [f for f in functions if "wgmma_" in f.splitlines()[0]]
        others = [f for f in functions if "wgmma_" not in f.splitlines()[0]]
        assert len(wgmma) == 4 * WGMMA_TILINGS.get(src, 2) + WGMMA_EXTRA.get(src, 0), \
            (src, [f.splitlines()[0] for f in functions])
        assert all("HGMMA" in f and "UTMALDG" in f for f in wgmma), src
        assert others and not any("HGMMA" in f or "UTMALDG" in f for f in others), src


def test_wgmma_main_path_instantiations_do_not_spill():
    """``-Xptxas -v`` of K1, K3, K4, K6, K8, K9 and K10: the instantiations the main
    paths run (bf16; head dim 64, each tiling of ``WGMMA_TILINGS``, both
    builds of ``EXACT_SOURCES``; K6 every tiling at int8 and int4,
    ``MAIN_PATH``) spill nothing; nor, with no stack frame either (but
    ``STACK_FRAMES``), do the 128-wide ones that ``[hd]`` runs at head dims
    80 and 96 and K1's 256-wide builds (the wgmma kernel and the f32 one)."""
    _card()
    from deepspeed_tpu_torch.ops import op_builder
    out_dir = os.path.join(REPO, "build", "ptxas_check")
    os.makedirs(out_dir, exist_ok=True)
    for src in _wgmma_libraries():
        proc = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v",
                               "-o", os.path.join(out_dir, src + ".so"),
                               os.path.join(op_builder.CSRC_DIR, src)],
                              capture_output=True, text=True, check=True)
        spills, entry = {}, None
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line and entry is not None:
                spills[entry] = line.split(":", 1)[-1].strip()
        mark, count = MAIN_PATH.get(src, ("13__nv_bfloat16Li64E", WGMMA_TILINGS.get(src, 2)
                                          * (2 if src in EXACT_SOURCES else 1)))
        main = {e: v for e, v in spills.items() if "wgmma_" in e and mark in e}
        assert len(main) == count, (src, list(spills))
        for e, v in main.items():
            print(f"[ptxas] {src} {e[:90]}: {v}")
            assert "0 bytes spill stores, 0 bytes spill loads" in v, (e, v)
        wide = {e: v for e, v in spills.items()
                if ("wgmma_" in e and "13__nv_bfloat16Li128E" in e) or "Li256E" in e}
        assert src not in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu") or wide, src
        for e, v in wide.items():
            print(f"[ptxas] {src} {e[:90]}: {v}")
            assert "0 bytes spill stores, 0 bytes spill loads" in v, (e, v)
            assert src in STACK_FRAMES or v.startswith("0 bytes stack frame"), (e, v)


@pytest.mark.parametrize("kernel,function", [("paged_decode_attention", "paged_decode_split"),
                                             ("decode_attention", "dense_decode_split")])
def test_paged_kernel_issues_bulk_copies_and_does_not_spill(kernel, function):
    """K5 and K2 load their pages and tiles by bulk copies (no tensor map):
    UBLKCP stands in the SASS of every instantiation (3 dtypes x 3 build widths
    x 3 head blocks x head_dim equal to the width or below it) and UTMALDG in
    none; ``-Xptxas -v`` shows no spills and
    no stack frame (no register array indexed at run time) in any of them."""
    _card()
    from deepspeed_tpu_torch.ops import op_builder
    src = op_builder.KERNELS[kernel].source
    op_builder.build([src])
    cuobjdump = os.path.join(os.path.dirname(op_builder._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", op_builder._library_path(src)],
                          capture_output=True, text=True, check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:]
                 if function in f.splitlines()[0]]
    assert len(functions) == 54, [f.splitlines()[0] for f in functions]
    for f in functions:
        ops = sorted({w.split(".")[0] for w in f.split() if w.startswith(("UBLK", "UTMA"))})
        assert "UBLKCP" in f and "UTMALDG" not in f, (f.splitlines()[0], ops)
    out_dir = os.path.join(REPO, "build", "ptxas_check")
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           os.path.join(out_dir, src + ".so"),
                           os.path.join(op_builder.CSRC_DIR, src)],
                          capture_output=True, text=True, check=True)
    spills, regs, entry = {}, {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            spills[entry] = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and entry is not None:
            regs[entry] = line.split(":", 1)[-1].strip()
    assert len(spills) == 54, list(spills)
    for e, v in spills.items():
        print(f"[ptxas] {src} {e}: {v}; {regs.get(e)}")
        assert v == "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", (e, v)
