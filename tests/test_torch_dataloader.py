"""The port's dataloader against the JAX package's, on the CPU.

``DeepSpeedDataLoader`` and ``RepeatingLoader`` must yield exactly JAX's
batches (numpy, compared bit for bit): an indexable dataset with shuffle on
and off over two epochs, ``drop_last`` on and off, two replicas, an iterable
dataset, and dict, tuple and user collates. Then the engine: both engines
take ``training_data`` (and the port's ``dataloader_drop_last`` and
``collate_fn``) and 3 ``train_batch()`` steps with no batch, gradient
accumulation 2, so each step draws two micro-batches; the losses agree within
``test_engine_trajectory_matches_jax``'s f32 tolerance (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.runtime import dataloader as torch_dl

TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)


def _dict_dataset(n=23, seq=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 100, seq).astype(np.int32),
             "labels": rng.integers(0, 100, seq).astype(np.int32)} for _ in range(n)]


def _tuple_dataset(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(3).astype(np.float32), np.int64(i)) for i in range(n)]


class _Stream:
    """An iterable dataset (no ``__getitem__``)."""

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        return iter(self.items)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _epochs(make, n_epochs=2):
    loader = make()
    out = []
    for epoch in range(n_epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out, len(loader) if loader._indexable else None


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("replicas", [(1, 0), (2, 1)], ids=["one", "rank1of2"])
@pytest.mark.parametrize("data", ["dict", "tuple"])
def test_loader_batches_match_jax(shuffle, drop_last, replicas, data):
    dataset = _dict_dataset() if data == "dict" else _tuple_dataset()
    n, rank = replicas
    kw = dict(batch_size=4, num_replicas=n, rank=rank, shuffle=shuffle, seed=5,
              drop_last=drop_last)
    want, want_len = _epochs(lambda: jax_dl.DeepSpeedDataLoader(dataset, **kw))
    got, got_len = _epochs(lambda: torch_dl.DeepSpeedDataLoader(dataset, **kw))
    assert got_len == want_len and len(got[0]) == want_len
    _same(got, want)
    if shuffle:
        assert not all(np.array_equal(a["input_ids"] if data == "dict" else a[0],
                                      b["input_ids"] if data == "dict" else b[0])
                       for a, b in zip(got[0], got[1]))


@pytest.mark.parametrize("drop_last", [True, False])
def test_iterable_dataset_and_repeating_loader_match_jax(drop_last):
    items = _dict_dataset(n=10)
    kw = dict(batch_size=4, num_replicas=2, rank=0, drop_last=drop_last)
    _same(list(torch_dl.DeepSpeedDataLoader(_Stream(items), **kw)),
          list(jax_dl.DeepSpeedDataLoader(_Stream(items), **kw)))
    with pytest.raises(TypeError):
        len(torch_dl.DeepSpeedDataLoader(_Stream(items), batch_size=4))
    jr = jax_dl.RepeatingLoader(jax_dl.DeepSpeedDataLoader(items, batch_size=3))
    tr = torch_dl.RepeatingLoader(torch_dl.DeepSpeedDataLoader(items, batch_size=3))
    assert len(tr) == len(jr) == 3
    _same([next(tr) for _ in range(7)], [next(jr) for _ in range(7)])


def test_user_collate_and_micro_batch_concat():
    items = _tuple_dataset(n=8)

    def collate(samples):
        return {"x": np.stack([s[0] for s in samples]) * 2}

    _same(list(torch_dl.DeepSpeedDataLoader(items, batch_size=4, collate_fn=collate)),
          list(jax_dl.DeepSpeedDataLoader(items, batch_size=4, collate_fn=collate)))
    micros = [torch_dl.default_collate(items[:3]), torch_dl.default_collate(items[3:6])]
    joined = torch_dl.concat_micro_batches(micros)
    _same(joined, torch_dl.default_collate(items[:6]))
    tens = torch_dl.concat_micro_batches([{"a": torch.ones(2, 3)}, {"a": torch.zeros(1, 3)}])
    assert tens["a"].shape == (3, 3) and tens["a"].sum() == 6


# ------------------------------------------------------------------ engine
def _config():
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "steps_per_print": 10**9, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}}}


def test_engine_with_training_data_matches_jax():
    """Both engines draw their batches from ``training_data``: 3 steps of
    ``train_batch()`` (2 micro-batches of 8 a step: 48 of the 50 sequences,
    then the loader wraps), losses within 1e-5; ``initialize`` returns the
    loader; the port's config takes ``dataloader_drop_last``."""
    rng = np.random.default_rng(0)
    data = [{"input_ids": rng.integers(0, TINY["vocab_size"], 32).astype(np.int32)}
            for _ in range(50)]
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32, attention_impl="xla")
    jengine, _, jloader, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=_config(),
                                           training_data=data)
    start = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32)
    sd = gpt2_params_from_jax(start, tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg), init_fn=lambda seed, device: sd)
    calls = []

    def collate(samples):
        calls.append(len(samples))
        return torch_dl.default_collate(samples)

    tengine, _, tloader, _ = dst.initialize(
        model=model, config=dict(_config(), dataloader_drop_last=True), training_data=data,
        collate_fn=collate, device="cpu")
    assert tloader is tengine.training_dataloader and tloader.drop_last
    assert len(tloader) == 6 and len(jloader) == 7        # JAX's engine: drop_last False
    for _ in range(3):
        want = float(jengine.train_batch())
        assert abs(tengine.train_batch().item() - want) <= 1e-5
    assert calls == [8] * 6 and tengine.global_steps == 3
    with pytest.raises(ValueError, match="training_data"):
        dst.initialize(model=model, config=_config(), device="cpu")[0].train_batch()
