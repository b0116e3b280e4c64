"""The port's training checkpoints on the CPU: save, load and resume, faults,
the autosaver, export, and serving a trained checkpoint.

A tiny GPT-2 (2 layers, width 64, vocab 128) trains on seeded batches. The
resume cases compare a run that saves, loads into a fresh engine of another
seed and goes on with an uninterrupted run, bit for bit (``torch.equal``), in
f32, bf16 and fp16; the fp16 case resumes from a state whose last step
overflowed and was skipped (a loss scale of 2**19 overflows the first step of
this model, and the sixth, once the scale has grown back). The fault
cases arm the port's fault points at the JAX package's sites. No JAX is
imported here: this module is also the child process of the kill-mid-save
case (``python tests/test_torch_checkpoint.py --dir D``).
The JAX side is held in ``tests/test_torch_checkpoint_interop.py``.
"""

import argparse
import dataclasses
import json
import os
import runpy
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:                # run as a script (the child process)
    sys.path.insert(0, REPO)

import deepspeed_tpu_torch as dst  # noqa: E402
from deepspeed_tpu_torch.checkpoint import (DeepSpeedCheckpoint,  # noqa: E402
                                            export_fp32_state_dict,
                                            export_universal_checkpoint)
from deepspeed_tpu_torch.config import DeepSpeedConfig  # noqa: E402
from deepspeed_tpu_torch.models import (GPT2Config, GPT2MoEConfig, gpt2_model,  # noqa: E402
                                        gpt2_moe_model)
from deepspeed_tpu_torch.models.gpt2 import init_params  # noqa: E402
from deepspeed_tpu_torch.module_inject import convert_training_model  # noqa: E402
from deepspeed_tpu_torch.observability.trace import get_tracer  # noqa: E402
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (  # noqa: E402
    MANIFEST_FILE, CheckpointCorruptionError, TorchCheckpointEngine, find_latest_committed_tag,
    is_committed_tag, validate_manifest, write_latest_pointer)
from deepspeed_tpu_torch.runtime.engine import CheckpointAutoSaver, state_tree  # noqa: E402
from deepspeed_tpu_torch.utils import zero_to_fp32  # noqa: E402
from deepspeed_tpu_torch.utils.fault_injection import FaultSpec, inject  # noqa: E402

TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)
SEQ = 32
PRECISIONS = {
    "float32": {},
    "bfloat16": {"bf16": {"enabled": True}},
    # 2**19 overflows steps 1 and 6 (skipped); hysteresis 1 halves the scale at once
    "float16": {"fp16": {"enabled": True, "initial_scale_power": 19, "hysteresis": 1,
                         "loss_scale_window": 2}},
}


def _config(precision="float32", **extra):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10**9,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 4, "warmup_max_lr": 1e-2,
                                     "warmup_type": "linear"}},
            **PRECISIONS[precision], **extra}


def _engine(precision="float32", seed=0, cfg=None, **extra):
    cfg = cfg or GPT2Config(**TINY, dtype=getattr(torch, precision))
    model = dataclasses.replace(gpt2_model(cfg),
                                init_fn=lambda _, device: init_params(cfg, seed, device))
    engine, _, _, _ = dst.initialize(model=model, config=_config(precision, **extra),
                                     device="cpu")
    return engine


def _batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"], (8, SEQ))} for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def _snapshot(engine):
    return {k: v.detach().clone() for k, v in _flat(state_tree(engine.state)).items()}


def _assert_equal(a, b, keys=None):
    keys = sorted(a) if keys is None else keys
    for k in keys:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- round trip
@pytest.mark.parametrize("async_save", [False, True])
def test_save_load_restores_every_tensor_and_counter(tmp_path, async_save):
    extra = {"checkpoint": {"async_save": True}} if async_save else {}
    a = _engine(**extra)
    assert a.checkpoint_engine.use_async is async_save
    for b in _batches(3):
        a.train_batch(b)
    saved, sched = _snapshot(a), a.lr_scheduler.state_dict()
    path = a.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    assert os.path.basename(path) == "global_step3"
    assert (tmp_path / "latest").read_text() == "global_step3"
    validate_manifest(path, strict=True)
    a.train_batch(_batches(1, seed=9)[0])           # the save holds copies, not views

    b = _engine(seed=5, **extra)
    refs = {k: v for k, v in _flat(state_tree(b.state)).items()}
    assert not torch.equal(refs["params.wte"], saved["params.wte"])
    got_path, client_state = b.load_checkpoint(str(tmp_path))
    assert got_path == path and client_state == {"epoch": 7}
    _assert_equal(_snapshot(b), saved)
    # written into the engine's own tensors: every reference stays valid
    for k, t in _flat(state_tree(b.state)).items():
        assert t is refs[k], k
    assert all(p.requires_grad for p in b.state.params.values())
    assert (b.global_steps, b.skipped_steps, b.micro_steps, b._host_steps) == (3, 0, 6, 3)
    assert b.lr_scheduler.state_dict() == sched == {"last_batch_iteration": 3}
    assert b.get_lr_value() == pytest.approx(1e-2 * 3 / 4)      # not stepped again


@pytest.mark.parametrize("mode", ["load_module_only", "load_optimizer_states"])
def test_module_only_and_no_optimizer_keep_the_engines_optimizer_and_scaler(tmp_path, mode):
    """JAX's split: the checkpoint's parameters and global_step, the engine's
    optimizer state, loss scaler and skipped-step count."""
    a = _engine("float16")
    for b in _batches(2):
        a.train_batch(b)
    assert a.skipped_steps == 1
    saved = _snapshot(a)
    a.save_checkpoint(str(tmp_path))
    b = _engine("float16", seed=5)
    b.train_batch(_batches(1, seed=3)[0])
    mine = _snapshot(b)
    kwargs = {mode: mode == "load_module_only"}
    b.load_checkpoint(str(tmp_path), **kwargs)
    got = _snapshot(b)
    taken = [k for k in got if k.startswith("params.") or k == "global_step"]
    kept = [k for k in got if k not in taken]
    assert kept and len(taken) == len(a.state.params) + 1
    _assert_equal(got, saved, taken)
    _assert_equal(got, mine, kept)
    assert b.global_steps == 2 and b._host_steps == 2 and b.micro_steps == 4


def test_load_checkpoint_on_an_empty_directory_returns_none(tmp_path):
    e = _engine()
    assert e.load_checkpoint(str(tmp_path)) == (None, {})
    assert e.load_checkpoint(str(tmp_path / "nope")) == (None, {})


def test_tagged_checkpoints_and_latest(tmp_path):
    e = _engine()
    batches = _batches(2)
    e.train_batch(batches[0])
    e.save_checkpoint(str(tmp_path), tag="alpha")
    e.train_batch(batches[1])
    e.save_checkpoint(str(tmp_path), tag="beta", save_latest=False)
    assert (tmp_path / "latest").read_text() == "alpha"
    e.save_checkpoint(str(tmp_path), tag="beta")        # a re-save replaces the tag
    assert (tmp_path / "latest").read_text() == "beta"
    assert sorted(os.listdir(tmp_path)) == ["alpha", "beta", "latest"]
    e2 = _engine(seed=1)
    assert os.path.basename(e2.load_checkpoint(str(tmp_path), tag="alpha")[0]) == "alpha"
    assert e2.global_steps == 1
    assert os.path.basename(e2.load_checkpoint(str(tmp_path))[0]) == "beta"
    assert e2.global_steps == 2


def test_a_mismatched_checkpoint_raises_and_leaves_the_state_whole(tmp_path):
    a = _engine()
    a.train_batch(_batches(1)[0])
    a.save_checkpoint(str(tmp_path))
    wide = GPT2Config(**dict(TINY, n_embd=32), dtype=torch.float32)
    b = _engine(cfg=wide)
    before = _snapshot(b)
    with pytest.raises(ValueError, match="params.wte is"):
        b.load_checkpoint(str(tmp_path))
    _assert_equal(_snapshot(b), before)
    assert b.global_steps == 0


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, precision):
    batches = _batches(6)
    cont = _engine(precision)
    want = [cont.train_batch(b) for b in batches]
    split = 1 if precision == "float16" else 2
    a = _engine(precision)
    for b in batches[:split]:
        a.train_batch(b)
    if precision == "float16":
        assert a.skipped_steps == 1                 # the step just before the save
    a.save_checkpoint(str(tmp_path))
    b = _engine(precision, seed=7)
    b.load_checkpoint(str(tmp_path))
    got = [b.train_batch(x) for x in batches[split:]]
    for w, g in zip(want[split:], got):
        assert torch.equal(w, g), (want, got)
    _assert_equal(_snapshot(b), _snapshot(cont))
    assert b.loss_scale() == cont.loss_scale() and b.get_lr() == cont.get_lr()
    if precision == "float16":
        assert cont.skipped_steps == b.skipped_steps == 2


def test_the_commit_is_traced(tmp_path):
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        e = _engine()
        e.save_checkpoint(str(tmp_path), tag="t")
        spans = [s for s in tracer.spans if s["name"] == "checkpoint_commit"]
    finally:
        tracer.disable()
        tracer.reset()
    assert len(spans) == 1 and spans[0]["cat"] == "train"
    assert spans[0]["attrs"] == {"tag": "t", "step": 0}


# ------------------------------------------------------------------ faults
def test_transient_io_error_is_retried_and_the_save_commits(tmp_path):
    e = _engine()
    e.train_batch(_batches(1)[0])
    with inject("ckpt.save.io", FaultSpec(kind="io_error", max_faults=2)) as fault:
        path = e.save_checkpoint(str(tmp_path), tag="t0")
    assert fault.fired == 2
    validate_manifest(path, strict=True)
    with inject("ckpt.load.io", FaultSpec(kind="io_error", max_faults=1)) as fault:
        e2 = _engine(seed=1)
        e2.load_checkpoint(str(tmp_path))
    assert fault.fired == 1 and e2.global_steps == 1


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
def test_a_damaged_shard_raises_naming_the_file(tmp_path, damage):
    e = _engine()
    e.train_batch(_batches(1)[0])
    path = e.save_checkpoint(str(tmp_path), tag="t0")
    manifest = json.load(open(os.path.join(path, MANIFEST_FILE)))
    victim = os.path.join("state", "params.pt")
    assert victim in manifest["files"]
    vpath = os.path.join(path, victim)
    if damage == "corrupt":                      # same size, one byte flipped
        blob = bytearray(open(vpath, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(vpath, "wb").write(bytes(blob))
        match = "SHA-256"
    else:
        with open(vpath, "r+b") as fh:
            fh.truncate(os.path.getsize(vpath) // 2)
        match = "truncated"
    e2 = _engine(seed=1)
    with pytest.raises(CheckpointCorruptionError, match=match) as err:
        e2.load_checkpoint(str(tmp_path), tag="t0")
    assert victim in str(err.value) and e2.global_steps == 0
    if damage == "truncate":
        # without the manifest check the reader still refuses it, naming the file (a
        # flipped byte in tensor data is found by the manifest's checksum alone)
        with pytest.raises(CheckpointCorruptionError, match="params.pt"):
            e2.load_checkpoint(str(tmp_path), tag="t0", validate=False)
        assert e2.global_steps == 0


@pytest.mark.parametrize("site", [
    "ckpt.save.begin", "ckpt.save", "ckpt.save.io",
    "ckpt.commit.manifest", "ckpt.manifest.hash", "ckpt.commit.rename", "ckpt.latest",
])
def test_atomic_commit_at_every_fault_site(tmp_path, site):
    """A fault at any save-path site leaves the new tag fully committed or not
    visible at all, and a loadable previous tag."""
    e = _engine()
    e.train_batch(_batches(1)[0])
    e.save_checkpoint(str(tmp_path), tag="good")
    e.train_batch(_batches(1, seed=1)[0])
    with inject(site, FaultSpec(kind="io_error")) as fault:
        with pytest.raises(OSError, match=f"site={site}"):
            e.save_checkpoint(str(tmp_path), tag="next")
    assert fault.fired >= 1
    if (tmp_path / "next").exists():
        validate_manifest(str(tmp_path / "next"), strict=True)
        assert site == "ckpt.latest" and (tmp_path / "latest").read_text() == "good"
    else:
        assert is_committed_tag(str(tmp_path), "good")
    e2 = _engine(seed=1)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "good" and e2.global_steps == 1


def test_a_torn_latest_pointer_falls_back_to_the_newest_committed_tag(tmp_path):
    e = _engine()
    e.train_batch(_batches(1)[0])
    e.save_checkpoint(str(tmp_path), tag="good")
    (tmp_path / "latest").write_text("phantom")
    (tmp_path / "phantom.tmp").mkdir()
    assert find_latest_committed_tag(str(tmp_path)) == "good"
    path, _ = _engine(seed=1).load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "good"


def test_sigkill_mid_save_then_resume_bit_for_bit(tmp_path):
    """A real SIGKILL inside a shard write of tag ``bad`` in a child process:
    the torn tag is not visible, ``latest`` still names ``good``, and this
    process resumes from it with step 3's loss equal bit for bit to the one the
    dead process took."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    crash = subprocess.run([sys.executable, os.path.abspath(__file__), "--dir",
                            str(tmp_path)], capture_output=True, text=True, timeout=120,
                           env=env, cwd=REPO)
    assert crash.returncode == -signal.SIGKILL, crash.stdout + crash.stderr
    assert (tmp_path / "latest").read_text() == "good"
    assert not (tmp_path / "bad").exists() and (tmp_path / "bad.tmp").exists()
    assert find_latest_committed_tag(str(tmp_path)) == "good"
    validate_manifest(str(tmp_path / "good"), strict=True)
    e = _engine(seed=1)
    path, _ = e.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "good" and e.global_steps == 2
    loss = e.train_batch(_batches(3)[2])
    assert loss.numpy().tobytes().hex() == (tmp_path / "expected.txt").read_text()
    e.save_checkpoint(str(tmp_path), tag="bad")          # reclaims the stale staging
    assert not (tmp_path / "bad.tmp").exists() and is_committed_tag(str(tmp_path), "bad")


def _child_main(argv) -> int:
    """The kill-mid-save child: 2 steps, commit ``good``, record step 3's loss,
    then die by SIGKILL inside the second shard write of tag ``bad``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    batches = _batches(3)
    e = _engine()
    e.train_batch(batches[0])
    e.train_batch(batches[1])
    e.save_checkpoint(args.dir, tag="good")
    loss = e.train_batch(batches[2])
    with open(os.path.join(args.dir, "expected.txt"), "w") as f:
        f.write(loss.numpy().tobytes().hex())
    with inject("ckpt.save.io", FaultSpec(kind="kill", after_n=1)):
        e.save_checkpoint(args.dir, tag="bad")
    return 7                                     # unreachable: the fault killed us


# --------------------------------------------------------------- autosaver
def test_autosaver_saves_on_its_interval(tmp_path):
    e = _engine()
    saver = CheckpointAutoSaver(e, str(tmp_path), interval_steps=2,
                                client_state_fn=lambda: {"n": e.global_steps})
    saved = []
    for b in _batches(4):
        e.train_batch(b)
        path = saver.after_step()
        if path:
            saved.append(os.path.basename(path))
    assert saved == ["global_step2", "global_step4"]
    assert saver.after_step() is None                   # already saved at 4
    assert _engine(seed=1).load_checkpoint(str(tmp_path))[1] == {"n": 4}


def test_sigterm_saves_marks_exits_143_and_resume_clears_the_marker(tmp_path):
    e = _engine()
    e.train_batch(_batches(1)[0])
    saved = _snapshot(e)
    with CheckpointAutoSaver(e, str(tmp_path)) as saver:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):                    # the handler runs between bytecodes
            if saver.preempted:
                break
            time.sleep(0.01)
        assert saver.preempted
        with pytest.raises(SystemExit) as exit_:
            saver.after_step()
        assert exit_.value.code == 128 + signal.SIGTERM == 143
    assert signal.getsignal(signal.SIGTERM) is not saver._on_sigterm
    marker = tmp_path / CheckpointAutoSaver.PREEMPT_MARKER
    assert marker.read_text() == "global_step1"
    e2 = _engine(seed=1)
    path, _ = CheckpointAutoSaver(e2, str(tmp_path)).resume()
    assert os.path.basename(path) == "global_step1" and not marker.exists()
    _assert_equal(_snapshot(e2), saved)


# ------------------------------------------------------------------ export
def test_export_is_read_by_plain_torch_and_zero_to_fp32_agrees(tmp_path, monkeypatch):
    e = _engine()
    for b in _batches(2):
        e.train_batch(b)
    e.save_checkpoint(str(tmp_path / "ck"))
    path = export_universal_checkpoint(e, str(tmp_path / "u"), tag="u1")
    assert (tmp_path / "u" / "latest_universal").read_text() == "u1"
    opt = e.state.opt_state
    for name, p in e.state.params.items():
        for kind, want in (("fp32", p), ("exp_avg", opt.exp_avg[name]),
                           ("exp_avg_sq", opt.exp_avg_sq[name])):
            got = torch.load(os.path.join(path, "zero", name, f"{kind}.pt"),
                             weights_only=True)
            assert got["cat_dim"] == 0 and torch.equal(got["param"], want.detach()), name
    ckpt = DeepSpeedCheckpoint(path)
    assert ckpt.get_iteration() == 2
    merged = ckpt.merged_state_dict()
    assert merged.keys() == e.state.params.keys()
    fp32 = export_fp32_state_dict(e, str(tmp_path / "fp32" / "pytorch_model.bin"))
    consolidated = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp_path / "ck"), str(tmp_path / "z.bin"))
    from_file = torch.load(tmp_path / "fp32" / "pytorch_model.bin", weights_only=True)
    for name, p in e.state.params.items():
        for sd in (merged, fp32, consolidated, from_file):
            assert torch.equal(sd[name], p.detach()), name
    # the CLI, as ``python -m deepspeed_tpu_torch.utils.zero_to_fp32`` runs it
    monkeypatch.setattr(sys, "argv", ["zero_to_fp32", str(tmp_path / "ck"),
                                      str(tmp_path / "cli.npz"), "--tag", "global_step2"])
    monkeypatch.delitem(sys.modules, zero_to_fp32.__name__)       # run it as __main__
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(zero_to_fp32.__name__, run_name="__main__")
    assert exit_.value.code == 0
    with np.load(tmp_path / "cli.npz") as npz:
        assert sorted(npz.files) == sorted(fp32)
        for name in fp32:
            np.testing.assert_array_equal(npz[name], fp32[name].numpy())


# ------------------------------------------------------------------ config
def test_the_checkpoint_block_is_read_and_its_unread_keys_refused():
    assert DeepSpeedConfig({"train_batch_size": 4,
                            "checkpoint": {"async_save": True}}).checkpoint_config.async_save
    assert not DeepSpeedConfig({"train_batch_size": 4,
                                "checkpoint": None}).checkpoint_config.async_save
    for key, value in (("load_universal", True), ("tag_validation", "Fail"),
                       ("use_node_local_storage", True), ("checkpoint_in_cpu", True)):
        with pytest.raises(NotImplementedError, match="not read by the JAX engine"):
            DeepSpeedConfig({"train_batch_size": 4, "checkpoint": {key: value}})
    with pytest.raises(ValueError, match="unknown checkpoint key"):
        DeepSpeedConfig({"train_batch_size": 4, "checkpoint": {"no_such": 1}})


# ------------------------------------------------------------------ serving
def _serving_tag(save_dir, state_dict, tag="serve"):
    """A committed tag whose params carry the serving model's names."""
    ckpt = TorchCheckpointEngine()
    path = ckpt.begin_tag(save_dir, tag)
    ckpt.save({"params": state_dict}, os.path.join(path, "state"))
    ckpt.commit_tag(save_dir, tag)
    write_latest_pointer(save_dir, tag)
    return os.path.join(save_dir, tag)


@pytest.mark.parametrize("quant", [None, {"enabled": True, "bits": 8, "group": 16}])
def test_a_trained_checkpoint_is_served(tmp_path, quant):
    """zero_to_fp32 -> convert_training_model -> init_inference serves the
    training forward (f32 logits within 1e-5); InferenceEngine.load_checkpoint
    of a tag with the serving names equals an engine built from them, with
    and without weight_quant."""
    cfg = GPT2Config(**TINY, dtype=torch.float32)
    e = _engine()
    for b in _batches(2):
        e.train_batch(b)
    e.save_checkpoint(str(tmp_path / "ck"))
    scfg, sd = convert_training_model(
        cfg, zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ck")))
    config = {"dtype": "float32", "max_out_tokens": 64}
    if quant:
        config["weight_quant"] = quant
    built = dst.init_inference((scfg, sd), config, device="cpu")
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 16))
    if not quant:
        with torch.no_grad():
            want = e.module.apply_fn(e.state.params, {"input_ids": torch.as_tensor(ids)})
        assert float((built.forward(ids) - want).abs().max()) <= 1e-5
    served = dst.init_inference(scfg, config, device="cpu")
    path = _serving_tag(str(tmp_path / "serve"), sd)
    assert served.load_checkpoint(str(tmp_path / "serve")) == path
    assert served.quant_audit == built.quant_audit
    assert torch.equal(served.forward(ids), built.forward(ids))
    np.testing.assert_array_equal(served.generate(ids, max_new_tokens=4),
                                  built.generate(ids, max_new_tokens=4))
    with pytest.raises(ValueError, match="missing .*layers.0.fc_in.bias"):
        served.load_checkpoint(str(tmp_path / "ck"))
    # MoE serving of a trained GPT2MoE is ported; residual MoE is refused, as in JAX
    moe_cfg = GPT2MoEConfig(vocab_size=64, n_positions=16, n_embd=16, n_layer=2, n_head=2,
                            num_experts=2, use_residual=True)
    with pytest.raises(NotImplementedError, match="residual-MoE"):
        convert_training_model(moe_cfg, gpt2_moe_model(moe_cfg).init(0, "cpu"))


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
