"""The port's checkpoints against the JAX package's, on the CPU.

- Protocol: the JAX package's ``validate_manifest``, ``is_committed_tag`` and
  ``find_latest_committed_tag`` give the port's functions' answers on a save
  directory the port wrote, and the port's give JAX's on one the JAX engine
  wrote, each with a staged (``.tmp``), a torn (unreadable manifest) and a
  corrupted tag added.
- Resume: a JAX engine and a port engine start from the same GPT-2 weights
  (carried by ``gpt2_params_from_jax``), take 2 steps and save; the JAX engine
  takes a third step and loads the tag back, the port's loads it into a fresh
  engine; each takes 2 more steps, and the 4 losses agree within
  ``test_engine_trajectory_matches_jax``'s f32 tolerance (1e-5). No LR
  schedule: the JAX engine's ``load_state_dict`` leaves the scheduler's last
  lr stale, so its first resumed step runs at lr 0 (the port's does not).
- Interop files: JAX's ``DeepSpeedCheckpoint`` reads the port's universal
  export and the port's reads JAX's, to the same tensors; on the tp-2
  Megatron checkpoint that JAX's ``test_reference_import.py`` synthesises both
  packages merge the same state, the port's ``to_causal_lm_params`` equals
  ``causal_lm_params_from_jax`` of JAX's tree exactly, and the port serves it
  to the ground truth's greedy rollout; the ZeRO-shard reconstruction and the
  reshape maps give JAX's answers.
- Train -> serve: the port's ``convert_training_model`` equals
  ``causal_lm_params_from_jax`` of JAX's ``convert_training_model`` exactly,
  and so does its config, but for the LayerNorm epsilon (the port keeps the
  training model's 1e-6).
- 1-bit Adam and 0/1 Adam tags (error feedback and counters) written by
  either package, carried into the other's format by renaming parameters,
  load there bit for bit and resume as the writer resumes.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.checkpoint import DeepSpeedCheckpoint as JaxDeepSpeedCheckpoint
from deepspeed_tpu.checkpoint import export_universal_checkpoint as jax_export_universal
from deepspeed_tpu.checkpoint import reshape as jax_reshape
from deepspeed_tpu.checkpoint import to_causal_lm_params as jax_to_causal_lm_params
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.module_inject.replace_module import \
    convert_training_model as jax_convert_training_model
from deepspeed_tpu.runtime.checkpoint_engine import checkpoint_engine as jax_ckpt
from deepspeed_tpu_torch.checkpoint import (DeepSpeedCheckpoint, Model3DDescriptor,
                                            export_fp32_state_dict,
                                            export_universal_checkpoint,
                                            get_model_3d_descriptor, reshape_3d,
                                            reshape_meg_2d_parallel, split_megatron_qkv,
                                            to_causal_lm_params)
from deepspeed_tpu_torch.models import (GPT2Config, causal_lm_params_from_jax, gpt2_model,
                                        gpt2_params_from_jax)
from deepspeed_tpu_torch.models.causal_lm import CausalLMConfig, causal_lm_model
from deepspeed_tpu_torch.module_inject import convert_training_model
from deepspeed_tpu_torch.runtime.checkpoint_engine import checkpoint_engine as torch_ckpt
from deepspeed_tpu_torch.runtime.engine import state_tree
from tests.unit.checkpoint.test_reference_import import (CFG as MEGATRON_CFG, _fuse_qkv,
                                                         _write_reference_checkpoint)

TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)
CONFIG = {"train_batch_size": 8, "steps_per_print": 10**9, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}}}
LOSS_TOL = 1e-5          # test_engine_trajectory_matches_jax's f32 tolerance


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY["vocab_size"], (8, 32)).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines from the same weights: 2 steps, save, a fresh engine loads
    and takes 2 more."""
    root = tmp_path_factory.mktemp("interop")
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32, attention_impl="xla")
    ja, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(CONFIG))
    start = jax.tree_util.tree_map(np.array, jax.device_get(ja.state.params))
    tcfg = GPT2Config(**TINY, dtype=torch.float32)
    sd = gpt2_params_from_jax(start, tcfg)

    def port_engine(init):
        model = dataclasses.replace(gpt2_model(tcfg), init_fn=lambda seed, device: init)
        return dst.initialize(model=model, config=dict(CONFIG), device="cpu")[0]

    ta = port_engine(sd)
    batches = _batches()
    losses = {"jax": [], "port": []}
    for ids in batches[:2]:
        losses["jax"].append(float(ja.train_batch({"input_ids": ids})))
        losses["port"].append(ta.train_batch({"input_ids": ids}).item())
    jdir, tdir = str(root / "jax"), str(root / "port")
    ja.save_checkpoint(jdir)
    ta.save_checkpoint(tdir)
    # the JAX engine loads back into itself after a step it must forget (a second
    # JAX engine would compile its step again); the port's into a fresh engine
    ja.train_batch({"input_ids": batches[3]})
    ja.load_checkpoint(jdir)
    tb = port_engine({k: torch.zeros_like(v) for k, v in sd.items()})
    tb.load_checkpoint(tdir)
    for ids in batches[2:]:
        losses["jax"].append(float(ja.train_batch({"input_ids": ids})))
        losses["port"].append(tb.train_batch({"input_ids": ids}).item())
    return dict(root=root, jdir=jdir, tdir=tdir, jax=ja, port=tb, tcfg=tcfg, jcfg=jcfg,
                losses=losses)


def test_save_load_step_matches_jax(runs):
    np.testing.assert_allclose(runs["losses"]["port"], runs["losses"]["jax"], atol=LOSS_TOL,
                               rtol=0)
    assert runs["port"].global_steps == runs["jax"].global_steps == 4
    assert runs["port"].micro_steps == runs["jax"].micro_steps == 4


def _answers(funcs, save_dir):
    """What one package's protocol functions say about every entry of
    ``save_dir`` (validation outcome as the error's type and failure mode)."""
    out = {"latest": funcs.find_latest_committed_tag(save_dir)}
    for name in sorted(os.listdir(save_dir)):
        if not os.path.isdir(os.path.join(save_dir, name)):
            continue
        try:
            funcs.validate_manifest(os.path.join(save_dir, name), strict=True)
            verdict = "valid"
        except Exception as e:           # noqa: BLE001 — the verdict is the comparison
            verdict = type(e).__name__ + ":" + next(
                (w for w in ("never", "unreadable", "missing", "truncated", "SHA-256")
                 if w in str(e)), "?")
        out[name] = (funcs.is_committed_tag(save_dir, name), verdict)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_packages_read_each_others_commit_protocol(runs, writer):
    save_dir = str(runs["root"] / f"protocol-{writer}")
    shutil.copytree(runs["tdir"] if writer == "port" else runs["jdir"], save_dir)
    good = os.path.join(save_dir, "global_step2")
    shutil.copytree(good, os.path.join(save_dir, "staged.tmp"))
    os.remove(os.path.join(save_dir, "staged.tmp", "manifest.json"))
    shutil.copytree(good, os.path.join(save_dir, "torn"))
    with open(os.path.join(save_dir, "torn", "manifest.json"), "w") as f:
        f.write("{\"files\": ")
    shutil.copytree(good, os.path.join(save_dir, "corrupt"))
    manifest = json.load(open(os.path.join(good, "manifest.json")))
    victim = max(manifest["files"], key=lambda k: manifest["files"][k]["size"])
    with open(os.path.join(save_dir, "corrupt", victim), "r+b") as f:
        f.seek(os.path.getsize(f.name) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    port, jax_ = _answers(torch_ckpt, save_dir), _answers(jax_ckpt, save_dir)
    assert port == jax_
    assert port["latest"] in ("global_step2", "corrupt")
    assert port["global_step2"] == (True, "valid")
    assert port["staged.tmp"] == (False, "CheckpointCorruptionError:never")
    assert port["torn"] == (False, "CheckpointCorruptionError:unreadable")
    assert port["corrupt"] == (True, "CheckpointCorruptionError:SHA-256")


def _named(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def test_deepspeed_checkpoint_reads_the_other_packages_export(runs):
    port_path = export_universal_checkpoint(runs["port"], str(runs["root"] / "u-port"))
    jax_path = jax_export_universal(runs["jax"], str(runs["root"] / "u-jax"))
    masters = {k: v.detach().numpy() for k, v in runs["port"].state.params.items()}
    by_jax = JaxDeepSpeedCheckpoint(port_path)
    assert by_jax.get_iteration() == 4
    got = _named(by_jax.merged_state_dict())
    assert got.keys() == masters.keys()
    for name, want in masters.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    want = _named(JaxDeepSpeedCheckpoint(jax_path).merged_state_dict())
    by_port = DeepSpeedCheckpoint(jax_path)
    assert by_port.get_iteration() == 4
    got = {k: v.numpy() for k, v in by_port.merged_state_dict().items()}
    assert got.keys() == want.keys() and "h.c_attn.kernel" in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_streamed_export_equals_the_resident_one_and_jax_reads_it(tmp_path):
    """A ZeRO-3 parameter-offload engine's universal export (masters and
    moments from its coordinator) equals, file for file, that of a resident
    engine whose optimizer runs the same host Adam (``offload_optimizer:
    cpu``) after the same 3 steps from the same weights (f32: bit for bit);
    JAX's ``DeepSpeedCheckpoint`` reads it as it reads the resident export;
    the fp32 state dict export holds the masters."""
    cfg = CausalLMConfig(vocab_size=64, max_seq_len=32, n_embd=32, n_layer=2, n_head=4,
                         dtype=torch.float32, tie_word_embeddings=True, name="tiny")
    start = causal_lm_model(cfg).init(0, "cpu")
    resident = dst.initialize(
        model=dataclasses.replace(causal_lm_model(cfg), init_fn=lambda seed, device: start),
        config=dict(CONFIG, zero_optimization={"stage": 3, "offload_optimizer": {
            "device": "cpu"}}), device="cpu")[0]
    streamed = dst.initialize(model=causal_lm_model(cfg, layers_per_group=1), config=dict(
        CONFIG, zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}}),
        device="cpu")[0]
    streamed._param_offload.load_full_params(start)
    rng = np.random.default_rng(1)
    for _ in range(3):
        ids = rng.integers(0, 64, (8, 16)).astype(np.int32)
        resident.train_batch({"input_ids": ids})
        streamed.train_batch({"input_ids": ids})
    paths = {name: export_universal_checkpoint(engine, str(tmp_path / name))
             for name, engine in (("resident", resident), ("streamed", streamed))}
    for name in start:
        for kind in ("fp32", "exp_avg", "exp_avg_sq"):
            got, want = (torch.load(os.path.join(paths[run], "zero", name, f"{kind}.pt"),
                                    weights_only=True)["param"]
                         for run in ("streamed", "resident"))
            assert torch.equal(got, want), (name, kind)
    by_jax = JaxDeepSpeedCheckpoint(paths["streamed"])
    assert by_jax.get_iteration() == 3
    got = _named(by_jax.merged_state_dict())
    masters = streamed._param_offload.full_params_host()
    assert got.keys() == masters.keys()
    for name, want in masters.items():
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)
    fp32 = export_fp32_state_dict(streamed, str(tmp_path / "fp32" / "pytorch_model.bin"))
    assert list(fp32) == list(masters) and all(torch.equal(fp32[k], masters[k]) for k in fp32)


def _megatron_port_cfg():
    return CausalLMConfig(vocab_size=MEGATRON_CFG.vocab_size,
                          max_seq_len=MEGATRON_CFG.max_seq_len, n_embd=MEGATRON_CFG.n_embd,
                          n_layer=MEGATRON_CFG.n_layer, n_head=MEGATRON_CFG.n_head,
                          dtype=torch.float32, tie_word_embeddings=True, name="tiny")


def test_megatron_import_matches_jax_and_serves_the_ground_truth(tmp_path):
    # the ground truth of test_reference_import.py (its _ground_truth_params),
    # jitted: the same values, without the eager trace
    module = JaxCausalLM(MEGATRON_CFG)
    params = jax.jit(module.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    _write_reference_checkpoint(params, str(tmp_path))
    assert get_model_3d_descriptor(str(tmp_path)) == Model3DDescriptor(1, 2, 1)
    ckpt, jckpt = DeepSpeedCheckpoint(str(tmp_path)), JaxDeepSpeedCheckpoint(str(tmp_path))
    assert (ckpt.get_iteration(), ckpt.layer_count) == (123, MEGATRON_CFG.n_layer + 2)
    merged, jmerged = ckpt.merged_state_dict(), _named(jckpt.merged_state_dict())
    assert merged.keys() == jmerged.keys()
    for name, want in jmerged.items():
        np.testing.assert_array_equal(merged[name].numpy(), want, err_msg=name)
    cfg = _megatron_port_cfg()
    sd = to_causal_lm_params(ckpt, n_head=cfg.n_head, n_layer=cfg.n_layer)
    want = causal_lm_params_from_jax(
        jax_to_causal_lm_params(jckpt, n_head=cfg.n_head, n_layer=cfg.n_layer), cfg)
    assert sd.keys() == want.keys()
    for name in want:
        assert torch.equal(sd[name], want[name]), name
    # served on the CPU: the ground-truth module's greedy rollout
    engine = dst.init_inference((cfg, sd), {"dtype": "float32",
                                            "max_out_tokens": cfg.max_seq_len}, device="cpu")
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    out = engine.generate(ids, max_new_tokens=4)
    # the ground truth's greedy rollout, one jitted causal forward over a fixed
    # length (a position's logits see only the tokens up to it)
    apply = jax.jit(lambda x: module.apply({"params": params}, x))
    cur = np.zeros((2, 10), np.int32)
    cur[:, :6] = ids
    for t in range(6, 10):
        cur[:, t] = np.asarray(jnp.argmax(apply(jnp.asarray(cur))[:, t - 1], axis=-1))
    np.testing.assert_array_equal(out, cur)
    # the fused qkv split inverts the fuse, as JAX's does
    w, b = _fuse_qkv(params["layers_0"])
    qw, _, vw = split_megatron_qkv(torch.from_numpy(w), cfg.n_head)
    np.testing.assert_array_equal(qw.numpy().T, np.asarray(params["layers_0"]["q_proj"]["kernel"]))
    np.testing.assert_array_equal(vw.numpy().T, np.asarray(params["layers_0"]["v_proj"]["kernel"]))


def test_zero_shards_reconstruct_as_in_jax(tmp_path):
    rng = np.random.RandomState(0)
    shapes = {"w1": (4, 3), "b1": (4,), "w2": (2, 4), "b2": (5,)}
    total = sum(int(np.prod(s)) for s in shapes.values())        # 29: the last rank pads 1
    flat = rng.standard_normal(total).astype(np.float32)
    dp, pad = 2, (-total) % 2
    parts = np.split(np.concatenate([flat, np.zeros(pad, np.float32)]), dp)
    torch.save({"param_shapes": shapes, "iteration": 7},
               os.path.join(tmp_path, "mp_rank_00_model_states.pt"))
    for r in range(dp):
        torch.save({"optimizer_state_dict": {
            "single_partition_of_fp32_groups": [torch.tensor(parts[r])], "zero_stage": 2,
            "group_paddings": [pad if r == dp - 1 else 0], "partition_count": dp}},
            os.path.join(tmp_path, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))
    ckpt = DeepSpeedCheckpoint(str(tmp_path))
    assert ckpt.src_3d.dp_degree == dp
    got = ckpt.reconstruct_fp32_state_dict()
    want = JaxDeepSpeedCheckpoint(str(tmp_path)).reconstruct_fp32_state_dict()
    assert got.keys() == want.keys() == shapes.keys()
    for name in shapes:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("args", [(2, 2, 2, 2), (1, 4, 1, 2), (4, 2, 2, 2), (2, 4, 1, 1)])
def test_reshape_maps_match_jax(args):
    got = reshape_meg_2d_parallel(*args)
    assert got == jax_reshape.reshape_meg_2d_parallel(*args)
    if args == (2, 2, 2, 2):
        assert got == {(0, 0): [0], (0, 1): [1], (1, 0): [2], (1, 1): [3]}
    if args == (1, 4, 1, 2):
        assert got == {(0, 0): [0, 1], (0, 1): [2, 3]}
    if args == (4, 2, 2, 2):
        assert got[(0, 0)] == [0, 2] and got[(1, 1)] == [5, 7]


def test_reshape_3d_and_expansion_match_jax():
    src, dst_ = Model3DDescriptor(2, 2, 2), Model3DDescriptor(2, 2, 1)
    maps = reshape_3d(src, dst_)
    assert maps == jax_reshape.reshape_3d(jax_reshape.Model3DDescriptor(2, 2, 2),
                                          jax_reshape.Model3DDescriptor(2, 2, 1))
    assert len(maps) == 1 and maps[0][(0, 0)] == [0, 4]
    ok, errs = Model3DDescriptor(1, 2, 1).can_reshape(Model3DDescriptor(1, 4, 1))
    assert not ok and "TP" in errs[0]


def test_convert_training_model_matches_jax(runs):
    jparams = jax.tree_util.tree_map(np.array, jax.device_get(runs["jax"].state.params))
    jcfg_serve, jtree = jax_convert_training_model(runs["jcfg"], jparams)
    cfg, sd = convert_training_model(runs["tcfg"], gpt2_params_from_jax(jparams, runs["tcfg"]))
    for field in ("vocab_size", "max_seq_len", "n_embd", "n_layer", "n_head", "pos_emb",
                  "activation", "tie_word_embeddings", "num_experts", "name"):
        assert getattr(cfg, field) == getattr(jcfg_serve, field), field
    assert (cfg.ln_eps, jcfg_serve.ln_eps) == (1e-6, 1e-5)
    want = causal_lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert sd.keys() == want.keys()
    for name in want:
        assert torch.equal(sd[name], want[name]), name


# ------------------------------------------------- 1-bit optimizer tags across
ONEBIT = {"OneBitAdam": {"freeze_step": 1, "weight_decay": 0.01},
          "ZeroOneAdam": {"var_freeze_step": 4, "var_update_scaler": 2}}
_PER_PARAM = ("params", "exp_avg", "exp_avg_sq", "error")


def _port_tree(jstate, tcfg):
    """A JAX ``TrainState`` dict (host arrays) as the port's ``state_tree``:
    per-parameter trees renamed by ``gpt2_params_from_jax``, every counter a
    0-d tensor of its dtype. The field names are the same on both sides."""
    def convert(name, x):
        if isinstance(x, tuple) and hasattr(x, "_asdict"):
            x = x._asdict()
        if isinstance(x, dict) and ("wte" in x or name in _PER_PARAM):
            return gpt2_params_from_jax(x, tcfg)
        if isinstance(x, dict):
            return {k: convert(k, v) for k, v in x.items()}
        return torch.from_numpy(np.array(x))
    return {k: convert(k, v) for k, v in jstate.items()}


def _jax_tree(tree, template):
    """The inverse, onto the JAX state's structure (``h_{i}`` blocks): a Dense
    ``weight`` goes back to a ``kernel`` (transposed), a norm's to ``scale``."""
    def back(x, jx, prefix=""):
        if isinstance(jx, dict) and "wte" in jx:
            out = {}
            for key, node in jx.items():
                tname = key.replace("h_", "h.")
                if not isinstance(node, dict):
                    out[key] = np.asarray(x[tname])
                    continue
                out[key] = {}
                for sub, leaf in node.items():
                    if not isinstance(leaf, dict):          # ln_f
                        w = x[f"{tname}.{'weight' if sub == 'scale' else sub}"]
                        out[key][sub] = np.asarray(w)
                        continue
                    out[key][sub] = {}
                    for k in leaf:
                        w = x[f"{tname}.{sub}.{'bias' if k == 'bias' else 'weight'}"]
                        out[key][sub][k] = np.asarray(w.t() if k == "kernel" else w)
            return out
        if isinstance(jx, dict):
            return {k: back(x[k], v) for k, v in jx.items()}
        if isinstance(jx, tuple) and hasattr(jx, "_asdict"):
            return type(jx)(**{k: back(x[k], v) for k, v in jx._asdict().items()})
        return np.asarray(x)
    return back(tree, template)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _flat(sub, f"{prefix}.{key}" if prefix else key).items()}


def _write_port_tag(save_dir, tag, tree, side):
    writer = torch_ckpt.TorchCheckpointEngine()
    staged = writer.begin_tag(save_dir, tag)
    writer.save(tree, os.path.join(staged, "state"))
    writer.save(side, os.path.join(staged, "client_state.pkl"))
    writer.commit_tag(save_dir, tag)
    torch_ckpt.write_latest_pointer(save_dir, tag)


@pytest.mark.parametrize("name", list(ONEBIT))
def test_onebit_tags_load_across_and_resume(name, tmp_path):
    """Both engines take 2 steps from one start under the optimizer (its
    compressed stage runs) and save. Each tag is carried into the other
    package's own format (the port's torch shards, JAX's Orbax) by renaming
    the parameters alone, since the state trees share their field names
    (error feedback, the step, 0/1 Adam's ``last_var_update`` and
    ``var_interval``, the loss scaler), and loaded there: every tensor equal
    to what was saved, bit for bit. The receiving engine's next step then
    matches the writing engine's own resumed step: the loss within 1e-5 and
    every counter equal. (Further steps part at the rounding noise, see
    ``test_torch_optimizers.py``.)"""
    from deepspeed_tpu.runtime.engine import TrainState as JaxTrainState
    config = dict(CONFIG, optimizer={"type": name, "params": {"lr": 1e-3, **ONEBIT[name]}})
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32, attention_impl="xla",
                               scan_layers=False)
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(config))
    tcfg = GPT2Config(**TINY, dtype=torch.float32)
    start = gpt2_params_from_jax(
        jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params)), tcfg)

    def port_engine(init):
        model = dataclasses.replace(gpt2_model(tcfg), init_fn=lambda seed, device: init)
        return dst.initialize(model=model, config=dict(config), device="cpu")[0]

    tengine = port_engine(start)
    batches = _batches()
    for ids in batches[:2]:
        jengine.train_batch({"input_ids": ids})
        tengine.train_batch({"input_ids": ids})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jengine.save_checkpoint(jdir, tag="t")
    tengine.save_checkpoint(tdir, tag="t")
    # each writer's own resumed step
    want_t = tengine.train_batch({"input_ids": batches[2]}).item()
    tengine.load_checkpoint(tdir, tag="t")
    assert tengine.train_batch({"input_ids": batches[2]}).item() == want_t
    jengine.load_checkpoint(jdir, tag="t")
    want_j = float(jengine.train_batch({"input_ids": batches[2]}))
    counters_j = state_tree(jax.device_get(jengine.state.opt_state))
    # JAX's tag -> the port
    jsaved = jengine.checkpoint_engine.load(os.path.join(jdir, "t", "state"),
                                            template=jengine.state._asdict())
    jside = jengine.checkpoint_engine.load(os.path.join(jdir, "t", "client_state.pkl"))
    tree = _port_tree(jax.tree_util.tree_map(np.asarray, jax.device_get(jsaved)), tcfg)
    _write_port_tag(str(tmp_path / "from-jax"), "t", tree, jside)
    receiver = port_engine({k: torch.zeros_like(v) for k, v in start.items()})
    receiver.load_checkpoint(str(tmp_path / "from-jax"))
    got = _flat(state_tree(receiver.state))
    assert sorted(got) == sorted(_flat(tree)) and "opt_state.error.wte" in got
    for key, value in _flat(tree).items():
        assert torch.equal(got[key], value), key
    assert abs(receiver.train_batch({"input_ids": batches[2]}).item() - want_j) <= LOSS_TOL
    counters = state_tree(receiver.state.opt_state)
    for key in ("step", "last_var_update", "var_interval"):
        if key in counters_j:
            assert int(counters[key]) == int(counters_j[key]), key
    assert receiver.global_steps == jengine.global_steps == 3
    # the port's tag -> JAX
    tsaved = torch_ckpt.TorchCheckpointEngine().load(os.path.join(tdir, "t", "state"))
    tside = torch_ckpt.TorchCheckpointEngine().load(os.path.join(tdir, "t",
                                                                 "client_state.pkl"))
    template = jax.device_get(jengine.state._asdict())
    jtree = _jax_tree(tsaved, template)
    jengine.state = JaxTrainState(**jax.device_put(jtree, jengine._state_shardings._asdict()))
    jengine._host_steps = tside["global_step"]
    jengine.save_checkpoint(str(tmp_path / "from-port"), tag="t")
    jengine.train_batch({"input_ids": batches[3]})          # a step the load must undo
    jengine.load_checkpoint(str(tmp_path / "from-port"))
    loaded = _flat(_port_tree(jax.tree_util.tree_map(np.asarray,
                                                     jax.device_get(jengine.state._asdict())),
                              tcfg))
    for key, value in _flat(tsaved).items():
        assert torch.equal(loaded[key], value), key
    assert abs(float(jengine.train_batch({"input_ids": batches[2]})) - want_t) <= LOSS_TOL
    counters_j = state_tree(jax.device_get(jengine.state.opt_state))
    for key in ("step", "last_var_update", "var_interval"):
        if key in counters_j:
            assert int(counters_j[key]) == int(state_tree(tengine.state.opt_state)[key]), key
