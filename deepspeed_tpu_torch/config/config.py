"""Training configuration: ``DeepSpeedConfig`` as a strict dataclass.

Counterpart of ``deepspeed_tpu/config/config.py`` (and of its ZeRO block,
``runtime/zero/config.py``), with DeepSpeed's JSON key names, built from a dict
or a path to a ``.json`` file. It takes the batch triple, resolved as the JAX
config resolves it (here with ``dp_world_size = 1``: one card), the optimizer
and scheduler blocks, bf16 and fp16 (with dynamic loss scaling), ZeRO stage 0
or 1 (on one card the stage-1 optimizer-state partition is the whole state),
gradient clipping, gradient prescaling, ``steps_per_print``, the
``checkpoint`` block (of which the engine reads ``async_save``) and the
``activation_checkpointing`` block (which ``checkpointing.configure`` reads,
as in the JAX package; the engine does not).

An unknown key raises ``ValueError``. A key the JAX config knows whose feature
is not ported yet, set to anything but its default, raises
``NotImplementedError`` naming the ``ROADMAP.md`` queue-1 item that ports it.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

from ..runtime.activation_checkpointing.checkpointing import POLICIES
from .config_utils import from_dict, is_off

_ITEM5 = "item 5 (remainder)"

#: top-level keys of the JAX config whose features are not ported, by item
UNPORTED_KEYS = {
    "mesh": "item 11", "comm_overlap": "item 11", "communication_data_type": "item 11",
    "dataloader_drop_last": _ITEM5,
    "comms_logger": "item 9", "tensorboard": "item 9", "wandb": "item 9",
    "csv_monitor": "item 9", "jsonl_monitor": "item 9", "flops_profiler": "item 9",
    "wall_clock_breakdown": "item 9", "memory_breakdown": "item 9", "dump_state": "item 9",
    "aio": "item 12", "disable_allgather": "item 12",
    "fp16_master_weights_and_gradients": "item 12",
    "pipeline": "item 13", "sparse_gradients": "item 13", "progressive_layer_drop": "item 13",
    "eigenvalue": "item 13", "elasticity": "item 13", "compression_training": "item 13",
    "quantize_training": "item 13", "data_efficiency": "item 13",
    "curriculum_learning": "item 13", "autotuning": "item 13",
}
#: optimizers the JAX engine builds that are not ported yet
UNPORTED_OPTIMIZERS = ("lamb", "fusedlamb", "onebitadam", "zerooneadam", "onebitlamb",
                       "adagrad")
ADAM_TYPES = ("adam", "adamw", "fusedadam")


class DeepSpeedConfigError(Exception):
    pass


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1 {item}")


@dataclasses.dataclass
class FP16Config:
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0          # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    def __post_init__(self):
        if self.auto_cast:
            raise _unported("fp16.auto_cast", _ITEM5)
        if self.loss_scale < 0 or self.initial_scale_power < 0 or self.hysteresis < 0 \
                or self.loss_scale_window <= 0 or self.min_loss_scale < 0:
            raise DeepSpeedConfigError(f"invalid fp16 block {self}")

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False


@dataclasses.dataclass
class ZeroConfig:
    stage: int = 0

    def __post_init__(self):
        if self.stage in (2, 3):
            raise _unported(f"ZeRO stage {self.stage}", "item 12")
        if self.stage not in (0, 1):
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, "
                                       f"got {self.stage}")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ZeroConfig":
        # every other key of the JAX ZeRO block (offload tiers, buckets,
        # persistence thresholds) belongs to the unported ZeRO work
        other = sorted(k for k, v in data.items() if k != "stage" and not is_off(v))
        if other:
            raise _unported(f"zero_optimization keys {other}", "item 12")
        return cls(stage=int(data.get("stage", 0)))


@dataclasses.dataclass
class CheckpointConfig:
    """The ``checkpoint`` block. ``async_save`` overlaps a save's shard writes
    on a writer thread. The JAX config accepts the other four keys, but its
    engine never reads them, so here each raises set away from its default."""
    tag_validation: str = "Warn"        # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    checkpoint_in_cpu: bool = False
    async_save: bool = False

    def __post_init__(self):
        unread = [f.name for f in dataclasses.fields(self)
                  if f.name != "async_save" and getattr(self, f.name) != f.default]
        if unread:
            raise NotImplementedError(
                f"checkpoint keys {unread} are not read by the JAX engine either (it "
                "accepts and ignores them); set away from their defaults they are refused")


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` block, read by
    ``checkpointing.configure`` (JAX ``ActivationCheckpointingConfig``).
    ``policy`` names a ``checkpointing.POLICIES`` entry; ``cpu_checkpointing``
    promotes it to ``offload_dots``. The JAX package never acts on the other
    five keys (``partition_activations`` it only logs), so here each raises
    set away from its default."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown activation_checkpointing.policy {self.policy!r}; "
                             f"known: {sorted(POLICIES)}")
        unread = [f.name for f in dataclasses.fields(self)
                  if f.name not in ("cpu_checkpointing", "policy")
                  and getattr(self, f.name) != f.default]
        if unread:
            raise NotImplementedError(
                f"activation_checkpointing keys {unread} are not read by the JAX package "
                "either (it accepts and ignores them); set away from their defaults they are "
                "refused" + ("; partitioned activations are a tensor-parallel feature: "
                             "ROADMAP.md queue 1 item 11"
                             if "partition_activations" in unread else ""))


@dataclasses.dataclass
class OptimizerConfig:
    """An Adam-family optimizer's hyperparameters (``optimizer.params``)."""
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: Optional[bool] = None       # default: True for adamw
    bias_correction: bool = True

    def __post_init__(self):
        self.betas = tuple(self.betas)


def _resolve_config_dict(config: Union[str, dict]) -> dict:
    if isinstance(config, dict):
        return dict(config)
    if isinstance(config, str) and os.path.exists(config):
        with open(config) as f:
            return json.load(f)
    raise DeepSpeedConfigError(f"expected a dict or a path to a .json file, got {config!r}")


class DeepSpeedConfig:
    """Parsed, checked, batch-resolved training configuration."""

    KNOWN = ("train_batch_size", "train_micro_batch_size_per_gpu",
             "gradient_accumulation_steps", "optimizer", "scheduler", "fp16", "bf16",
             "bfloat16", "zero_optimization", "gradient_clipping", "prescale_gradients",
             "gradient_predivide_factor", "steps_per_print", "checkpoint",
             "activation_checkpointing")

    def __init__(self, config: Union[str, dict], dp_world_size: int = 1):
        pd = _resolve_config_dict(config)
        unknown = sorted(set(pd) - set(self.KNOWN) - set(UNPORTED_KEYS))
        if unknown:
            raise ValueError(f"unknown training config key(s) {unknown}")
        for key in sorted(set(pd) & set(UNPORTED_KEYS)):
            if not is_off(pd[key]):
                raise _unported(f"config key {key!r}", UNPORTED_KEYS[key])
        self._param_dict = pd

        self.fp16 = from_dict(FP16Config, pd.get("fp16", {}), "fp16")
        self.bf16 = from_dict(BF16Config, pd.get("bf16", pd.get("bfloat16", {})), "bf16")
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.zero_config = ZeroConfig.from_dict(pd.get("zero_optimization", {}))
        self.checkpoint_config = from_dict(CheckpointConfig, pd.get("checkpoint") or {},
                                           "checkpoint")
        self.activation_checkpointing = from_dict(
            ActivationCheckpointingConfig, pd.get("activation_checkpointing") or {},
            "activation_checkpointing")

        self.optimizer_name: Optional[str] = None
        self.optimizer_params = OptimizerConfig()
        if "optimizer" in pd:
            block = dict(pd["optimizer"])
            name = block.pop("type", None)
            params = block.pop("params", {})
            if block:
                raise ValueError(f"unknown optimizer key(s) {sorted(block)}")
            self.optimizer_name = name.lower() if name else None
            if self.optimizer_name in UNPORTED_OPTIMIZERS:
                raise _unported(f"optimizer {name!r}", _ITEM5)
            if self.optimizer_name not in (None,) + ADAM_TYPES:
                raise ValueError(f"unknown optimizer {name!r} (ported: {ADAM_TYPES})")
            self.optimizer_params = from_dict(OptimizerConfig, params, "optimizer.params")
        self.scheduler_name: Optional[str] = None
        self.scheduler_params: Dict[str, Any] = {}
        if "scheduler" in pd:
            block = dict(pd["scheduler"])
            self.scheduler_name = block.pop("type", None)
            self.scheduler_params = dict(block.pop("params", {}))
            if block:
                raise ValueError(f"unknown scheduler key(s) {sorted(block)}")

        self.gradient_clipping: float = float(pd.get("gradient_clipping", 0.0))
        self.prescale_gradients: bool = bool(pd.get("prescale_gradients", False))
        self.gradient_predivide_factor: float = float(pd.get("gradient_predivide_factor",
                                                             1.0))
        self.steps_per_print: int = int(pd.get("steps_per_print", 10))

        self.train_batch_size: Optional[int] = pd.get("train_batch_size")
        self.train_micro_batch_size_per_gpu: Optional[int] = pd.get(
            "train_micro_batch_size_per_gpu")
        self.gradient_accumulation_steps: Optional[int] = pd.get("gradient_accumulation_steps")
        self.resolve_batch_config(dp_world_size)

    def resolve_batch_config(self, dp_world_size: int) -> None:
        """Fill in the batch triple from the keys given, as the JAX config does."""
        if dp_world_size < 1:
            raise DeepSpeedConfigError(f"dp_world_size must be >= 1, got {dp_world_size}")
        self.dp_world_size = dp_world_size
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            pass
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp_world_size)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas, mb = 1, tb // dp_world_size
        elif mb is not None:
            gas, tb = 1, mb * dp_world_size
        else:
            raise DeepSpeedConfigError("at least one of train_batch_size / "
                                       "train_micro_batch_size_per_gpu must be set")
        if tb <= 0 or mb <= 0 or gas <= 0:
            raise DeepSpeedConfigError(f"batch sizes must be positive: train={tb} "
                                       f"micro={mb} gas={gas}")
        if tb != mb * gas * dp_world_size:
            raise DeepSpeedConfigError(
                f"train_batch_size ({tb}) != micro_batch_per_device ({mb}) * "
                f"gradient_accumulation_steps ({gas}) * dp_world_size ({dp_world_size})")
        self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps = tb, mb, gas

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage
