"""The port's MoE gating, selected-expert FFN and MoE CausalLM against the JAX
package's, on the CPU.

Inputs come from seeded numpy generators and go to both packages as they are.
JAX's ``moe_decode_ffn`` runs its Pallas kernel in interpret mode here; the
port's wrapper runs its plain version on CPU tensors. Tolerances, stated per
test: f32 where the point is the algorithm (sums in another order, 1e-5 on
values of order 1; the model 1e-4, the port's model tolerance), the kernel
check's bf16 limits (``kernel_checks.MOE_TOLERANCES``) where both sides round
h to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu.moe import sharded_moe as jax_moe
from deepspeed_tpu.ops import moe as jax_ops_moe
from deepspeed_tpu.ops.quantizer import quant as jax_quant
from deepspeed_tpu_torch import moe as torch_moe
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.ops import kernel_checks, op_builder
from deepspeed_tpu_torch.ops import moe as torch_ops_moe
from deepspeed_tpu_torch.ops.quantizer import make_quant_node

F32_ATOL = 1e-5
MODEL_ATOL = 1e-4
ACTS = ("gelu", "relu", "silu")


def _jax_act(name):
    return jax_lm._act(jax_lm.CausalLMConfig(activation=name))


# --------------------------------------------------------------------------- gating
def _logits(seed, s=40, e=6):
    return np.random.default_rng(seed).standard_normal((s, e)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_topk_select_matches_jax(k):
    logits = _logits(k)
    jidx, jw = jax_moe.topk_select(jnp.asarray(logits), k)
    tidx, tw = torch_moe.topk_select(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)


@pytest.mark.parametrize("drop_tokens", [True, False], ids=["drop", "no-drop"])
@pytest.mark.parametrize("k", [1, 2])
def test_gating_matches_jax(k, drop_tokens):
    """Eval settings (no noise, no RTS): capacity-bounded with drops (capacity
    factor 1, min 4: some of 40 tokens over 6 experts overflow) and without."""
    logits = _logits(10 + k)
    if k == 1:
        ref = jax_moe.top1gating(jnp.asarray(logits), 1.0, 4, drop_tokens=drop_tokens,
                                 use_rts=False)
        got = torch_moe.top1gating(torch.from_numpy(logits), 1.0, 4, drop_tokens=drop_tokens,
                                   use_rts=False)
    else:
        ref = jax_moe.top2gating(jnp.asarray(logits), 1.0, 4, drop_tokens=drop_tokens,
                                 top2_2nd_expert_sampling=False)
        got = torch_moe.top2gating(torch.from_numpy(logits), 1.0, 4, drop_tokens=drop_tokens,
                                   top2_2nd_expert_sampling=False)
    l_aux, combine, dispatch, counts = got
    assert combine.shape == ref[1].shape
    np.testing.assert_allclose(float(l_aux), float(ref[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(combine.numpy(), np.asarray(ref[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[3]))
    if drop_tokens:
        assert int(dispatch.sum()) < k * logits.shape[0]        # the capacity did drop


@pytest.mark.parametrize("k", [1, 2])
def test_topk_gate_eval_matches_jax(k):
    rng = np.random.default_rng(20 + k)
    x = rng.standard_normal((30, 16)).astype(np.float32)
    wg = rng.standard_normal((16, 5)).astype(np.float32)
    jgate = jax_moe.TopKGate(k=k, drop_tokens=False, use_rts=False,
                             top2_2nd_expert_sampling=False)
    tgate = torch_moe.TopKGate(k=k, drop_tokens=False, use_rts=False,
                               top2_2nd_expert_sampling=False)
    ref = jgate(jnp.asarray(wg), jnp.asarray(x), train=False)
    got = tgate(torch.from_numpy(wg), torch.from_numpy(x), train=False)
    assert got[1].shape == (30, 5, 30 * k)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_gating_noise_comes_from_the_generator():
    """RSample noise, RTS and the top-2 sampling draw from the generator only:
    one seed gives one result, and capacity still bounds every expert."""
    logits = torch.from_numpy(_logits(30, s=64, e=4))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        a = torch_moe.top1gating(logits, 1.0, 4, noisy_gate_policy="RSample", generator=gen)
        b = torch_moe.top2gating(logits, 1.0, 4, generator=gen)
        return a, b

    (a1, b1), (a2, b2) = run(0), run(0)
    for x, y in ((a1, a2), (b1, b2)):
        assert torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])
    for _, _, dispatch, _ in (a1, b1):
        assert int(dispatch.sum(dim=(0, 2)).max()) <= dispatch.shape[-1]
    gate = torch_moe.TopKGate(k=1, noisy_gate_policy="Jitter")
    wg = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    g1 = gate(wg, x, generator=torch.Generator().manual_seed(3))
    g2 = gate(wg, x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1[1], g2[1])


def test_capacity_matches_jax():
    for args in ((40, 6, 1.0, 4), (7, 8, 1.25, 4), (1000, 64, 2.0, 1)):
        assert torch_moe._capacity(*args) == jax_moe._capacity(*args)


def test_training_names_are_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        from deepspeed_tpu_torch.moe import MoE  # noqa: F401
    with pytest.raises(AttributeError):
        torch_moe.no_such_name


# ----------------------------------------------------------- selected-expert FFN
def _ffn_inputs(seed, n, k, e=6, d=32, f=128):
    """n tokens, k distinct experts each (rows repeated k times, as the
    model does); weights scaled so h and y are of order 1."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    x = np.repeat(rng.standard_normal((n, d)), k, axis=0).astype(np.float32)
    return {"x": x, "idx": idx,
            "w1": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            "b1": (0.5 * rng.standard_normal((e, f))).astype(np.float32),
            "w2": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32),
            "b2": (0.5 * rng.standard_normal((e, d))).astype(np.float32)}


def _to_jax(inp, dtype):
    return [jnp.asarray(inp[n]).astype(dtype) if n != "idx" else jnp.asarray(inp[n])
            for n in ("x", "idx", "w1", "b1", "w2", "b2")]


def _to_torch(inp, dtype):
    return [torch.from_numpy(inp[n]).to(dtype) if n != "idx" else torch.from_numpy(inp[n])
            for n in ("x", "idx", "w1", "b1", "w2", "b2")]


FFN_CASES = [(n, k, act) for n in (1, 4) for k in (1, 2) for act in ACTS]
FFN_IDS = [f"n{n}-k{k}-{act}" for n, k, act in FFN_CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,act", FFN_CASES + [(3, 1, "gelu")],
                         ids=FFN_IDS + ["ragged-d24-f200"])
def test_moe_decode_ffn_plain_matches_jax_kernel(n, k, act, dtype):
    """The port's wrapper on CPU tensors (the plain version) against JAX's
    ``moe_decode_ffn``, whose Pallas kernel runs in interpret mode (one
    f-block where no block width divides f). f32: 1e-5. bf16: both round h
    to bf16 once after f32 sums in other orders, the kernel check's limit."""
    shape = dict(d=24, f=200) if n == 3 else {}
    inp = _ffn_inputs(100 * n + 10 * k + ACTS.index(act), n, k, **shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_ops_moe.moe_decode_ffn(*_to_jax(inp, jdt), _jax_act(act)))
    op_builder.reset_launch_counts()
    got = torch_ops_moe.moe_decode_ffn(*_to_torch(inp, tdt), act)
    assert op_builder.launch_counts()["moe_decode_ffn"] == 0          # CPU: plain
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL, rtol=0)
    else:
        atol, rtol = kernel_checks.MOE_TOLERANCES[torch.bfloat16]
        assert kernel_checks.err_ratio(got, torch.from_numpy(ref), atol, rtol) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,act", FFN_CASES + [(3, 1, "gelu")],
                         ids=FFN_IDS + ["ragged-d24-f200"])
def test_moe_decode_ffn_xla_matches_jax(n, k, act, dtype):
    """The gather path, products and bias adds rounded in the serve dtype.
    f32: 1e-5. bf16: each side rounds after every product and add; XLA and
    torch may evaluate the activation at another precision before its
    rounding, which moves an h element by an ulp and y by ulp(h) x |w2| on
    top of y's own ulp: 2e-2 + 2e-2 |y| (two to three bf16 ulps at |y| ~ 1)."""
    shape = dict(d=24, f=200) if n == 3 else {}
    inp = _ffn_inputs(200 + 100 * n + 10 * k + ACTS.index(act), n, k, **shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_ops_moe.moe_decode_ffn_xla(*_to_jax(inp, jdt), _jax_act(act)))
    got = torch_ops_moe.moe_decode_ffn_xla(*_to_torch(inp, tdt), act)
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL, rtol=0)
    else:
        assert kernel_checks.err_ratio(got, torch.from_numpy(ref), 2e-2, 2e-2) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_moe_decode_ffn_quant_matches_jax(bits, dtype):
    """Quantized expert stacks (grouped per expert along axis -2, int4
    packed): the same nodes, from JAX's quantizer, into both packages. f32:
    1e-5; bf16: the gather path's limit (see the xla test)."""
    inp = _ffn_inputs(300 + bits, 4, 2, d=64, f=128)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jnodes, tnodes = {}, {}
    for name in ("w1", "w2"):
        q, s = jax_quant.quantize_grouped(jnp.asarray(inp[name]), 16, bits=bits)
        if bits == 4:
            q = jax_quant.pack_int4(q, s.shape[-2])
        jnodes[name] = ({"__int8_q__": q, "__int8_scale__": s} if bits == 8 else
                        {"__int4_q__": q, "__int4_scale__": s})
        tnodes[name] = make_quant_node(torch.from_numpy(np.asarray(q)),
                                       torch.from_numpy(np.asarray(s)), bits)
    jx, jidx, _, jb1, _, jb2 = _to_jax(inp, jdt)
    tx, tidx, _, tb1, _, tb2 = _to_torch(inp, tdt)
    ref = np.asarray(jax_ops_moe.moe_decode_ffn_quant(jx, jidx, jnodes["w1"], jb1, jnodes["w2"],
                                                      jb2, _jax_act("gelu")))
    got = torch_ops_moe.moe_decode_ffn_quant(tx, tidx, tnodes["w1"], tb1, tnodes["w2"], tb2,
                                             "gelu")
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL, rtol=0)
    else:
        assert kernel_checks.err_ratio(got, torch.from_numpy(ref), 2e-2, 2e-2) <= 1.0


def test_pick_block_f_and_refusals():
    """The kernel's plan (f-block width and kernel, from the shapes alone) at
    the check cases' shapes, and the wrapper's refusals."""
    from deepspeed_tpu_torch.ops.moe.decode_ffn import MMA, SLAB
    plan = torch_ops_moe.moe_plan
    # GPT-2 MoE (d 768, f 3072, bf16): the tensor-core kernel for one or two
    # tokens, the slab kernel (the first version's widths) for more
    assert plan(1, 768, 3072, 2) == (16, MMA)
    assert plan(2, 768, 3072, 2) == (16, MMA)
    assert plan(16, 768, 3072, 2) == (128, SLAB)
    assert plan(64, 768, 3072, 2) == (128, SLAB)
    assert plan(3, 512, 2048, 2) == (64, SLAB)
    # the tensor-core kernel's shared memory past 227 KB (GPT-2 6.7B's and
    # 13B's widths): the slab kernel
    assert plan(1, 4096, 16384, 2) == (128, SLAB)
    assert plan(2, 5120, 20480, 2) == (128, SLAB)
    # f32, and d or f not a multiple of 8: the slab kernel
    assert plan(1, 768, 3072, 4) == (32, SLAB)
    assert plan(4, 256, 1024, 4) == (32, SLAB)
    assert plan(3, 77, 201, 2) == (16, SLAB)
    assert plan(1, 96, 200, 2) == (16, MMA)
    inp = _to_torch(_ffn_inputs(5, 2, 1), torch.float32)
    with pytest.raises(ValueError, match="activation"):
        torch_ops_moe.moe_decode_ffn(*inp, "tanh")
    with pytest.raises(ValueError, match="b1"):
        torch_ops_moe.moe_decode_ffn(*inp[:3], inp[3][:, :-1], *inp[4:])
    with pytest.raises(TypeError, match="share one"):
        torch_ops_moe.moe_decode_ffn(inp[0].bfloat16(), *inp[1:])
    with pytest.raises(TypeError, match="integer"):
        torch_ops_moe.moe_decode_ffn(inp[0], inp[1].float(), *inp[2:])


# ------------------------------------------------------------------ the model
TINY = dict(vocab_size=96, max_seq_len=512, n_embd=32, n_layer=2, n_head=4, num_experts=4)
MODELS = {"gpt2-top1": ("gpt2", {}), "gpt2-top2": ("gpt2", {"moe_top_k": 2}),
          "llama-gqa-top1": ("llama", {"n_kv_head": 2})}


def _models(name, seed=0, **extra):
    family, kw = MODELS[name]
    kw = {**kw, **extra}
    jcfg = jax_lm.FAMILIES[family](**TINY, **kw, dtype=jnp.float32)
    tcfg = torch_lm.FAMILIES[family](**TINY, **kw, dtype=torch.float32)
    shapes = jax.eval_shape(jax_lm.CausalLM(jcfg).init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):                  # norm scales around 1, all else around 0
        centre = 1.0 if path[-1].key == "scale" else 0.0
        return (centre + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = torch_lm.CausalLM(tcfg, device="cpu")
    model.load_state_dict(causal_lm_params_from_jax(params, tcfg))
    model.requires_grad_(False)
    return jcfg, params, model


def test_moe_parameters_match_the_jax_tree():
    """Every MoE layer holds the JAX tree's gate and expert stacks, in its
    shapes, and no dense FFN; the parameter count is JAX's; seeded init
    draws the experts at init_std with zero biases."""
    jcfg, params, model = _models("gpt2-top1")
    sd = model.state_dict()
    for i in range(jcfg.n_layer):
        layer = params[f"layers_{i}"]
        if jcfg.is_moe_layer(i):
            assert sd[f"layers.{i}.moe_gate"].shape == layer["moe_gate"].shape
            for leaf, arr in layer["moe_experts"].items():
                assert sd[f"layers.{i}.moe_experts.{leaf}"].shape == arr.shape
            assert not hasattr(model.layers[i], "fc_in")
        else:
            assert "moe_gate" not in layer and hasattr(model.layers[i], "fc_in")
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert model.cfg.num_params() == jcfg.num_params()
    cfg = torch_lm.gpt2_cfg(vocab_size=96, max_seq_len=64, n_embd=64, n_layer=2, n_head=4,
                            num_experts=8)
    fresh = torch_lm.CausalLM(cfg, device="cpu")
    fresh.init_weights(0)
    ex = fresh.layers[1].moe_experts
    for w in (ex.w1, ex.w2, fresh.layers[1].moe_gate):
        assert abs(float(w.std()) - cfg.init_std) < 0.1 * cfg.init_std
    assert float(ex.b1.abs().sum()) == 0.0 and float(ex.b2.abs().sum()) == 0.0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_logits_match_jax(name):
    """Prefill over right-padded 300-token prompts (two MOE_CHUNK chunks of
    the one-hot dispatch), then one decode step through the fast path with
    each impl and with the fast path off (the dispatch at t = 1). f32, 1e-4."""
    jcfg, params, model = _models(name)
    b, t, cap = 2, 300, 320
    ids = np.random.default_rng(1).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)
    lens = np.array([300, 271], np.int32)
    module = jax_lm.CausalLM(jcfg)
    jl, jcache = module.apply({"params": params}, jnp.asarray(ids),
                              caches=jax_lm.init_cache(jcfg, b, cap),
                              cache_lens=jnp.zeros(b, jnp.int32),
                              logits_positions=jnp.asarray(lens - 1))
    caches = torch_lm.init_cache(model.cfg, b, cap, device="cpu")
    tl, _ = model(torch.from_numpy(ids), caches=caches,
                  cache_lens=torch.zeros(b, dtype=torch.int32),
                  logits_positions=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_ATOL, rtol=0)

    tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None].astype(np.int32)
    tlens = torch.from_numpy(lens)
    base = [{k: v.clone() for k, v in c.items()} for c in caches]
    for impl, fast in (("pallas", True), ("xla", True), ("pallas", False)):
        jstep = jax_lm.CausalLM(jax_lm.FAMILIES[MODELS[name][0]](
            **TINY, **MODELS[name][1], dtype=jnp.float32, moe_decode_impl=impl,
            moe_decode_fastpath=fast))
        jl2, _ = jstep.apply({"params": params}, jnp.asarray(tok),
                             positions=jnp.asarray(lens)[:, None], caches=jcache,
                             cache_lens=jnp.asarray(lens))
        model.cfg.moe_decode_impl, model.cfg.moe_decode_fastpath = impl, fast
        step = [{k: v.clone() for k, v in c.items()} for c in base]
        tl2, _ = model(torch.from_numpy(tok), positions=tlens[:, None], caches=step,
                       cache_lens=tlens)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=MODEL_ATOL, rtol=0,
                                   err_msg=f"{impl} fastpath={fast}")


@pytest.mark.parametrize("k", [1, 2])
def test_bf16_routing_matches_jax(k):
    """Serve-dtype routing: bf16 tokens and a bf16 gate (the engines cast the
    2-D gate), logits ``x.f32 @ gate.f32`` in each package, then top-k. The
    expert ids must equal JAX's wherever the top-two logits differ by more
    than 1e-4: the two f32 products sum in other orders, so a nearer tie may
    flip between packages."""
    rng = np.random.default_rng(40 + k)
    d, e = 64, 8
    x = rng.standard_normal((256, d)).astype(np.float32)
    wg = (0.02 * rng.standard_normal((d, e))).astype(np.float32)
    tx, twg = torch.from_numpy(x).bfloat16(), torch.from_numpy(wg).bfloat16()
    jx, jwg = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wg).astype(jnp.bfloat16)
    tlogits = tx.float() @ twg.float()
    jidx, jw = jax_moe.topk_select(jx.astype(jnp.float32) @ jwg.astype(jnp.float32), k)
    tidx, tw = torch_moe.topk_select(tlogits, k)
    top2 = tlogits.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4).numpy()
    assert clear.sum() >= 200
    np.testing.assert_array_equal(tidx.numpy()[clear], np.asarray(jidx)[clear])
    np.testing.assert_allclose(tw.numpy()[clear], np.asarray(jw)[clear], atol=1e-5, rtol=0)


def test_moe_decode_impl_is_validated():
    with pytest.raises(ValueError, match="moe_decode_impl='triton'"):
        torch_lm.gpt2_cfg(**TINY, moe_decode_impl="triton")
    with pytest.raises(ValueError, match="moe_decode_impl='XLA'"):
        torch_lm.gpt2_cfg(**TINY, moe_decode_impl="XLA")
    # a config changed after construction is caught when a decode step routes
    _, _, model = _models("gpt2-top1")
    model.cfg.moe_decode_impl = "Pallas"
    caches = torch_lm.init_cache(model.cfg, 1, 16, device="cpu")
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="moe_decode_impl='Pallas'"):
        model(torch.zeros(1, 1, dtype=torch.long), positions=lens[:, None], caches=caches,
              cache_lens=lens)
