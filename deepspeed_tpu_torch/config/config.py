"""Training configuration: ``DeepSpeedConfig`` as a strict dataclass.

Counterpart of ``deepspeed_tpu/config/config.py`` (and of its ZeRO block,
``runtime/zero/config.py``), with DeepSpeed's JSON key names, built from a dict
or a path to a ``.json`` file. It takes the batch triple, resolved as the JAX
config resolves it (here with ``dp_world_size = 1``: one card), the optimizer
(Adam, AdamW, Adagrad, LAMB and the three 1-bit optimizers, with their
``freeze_step``, ``var_freeze_step``, ``var_update_scaler`` and LAMB's
coefficient bounds) and scheduler blocks, bf16 and fp16 (with dynamic loss
scaling), ``dataloader_drop_last``, ZeRO stages
0-3 (on one card the data-parallel group is one, so every partition of
optimizer state, gradients or parameters is the whole), ZeRO-Offload's
``offload_optimizer`` (``cpu`` or ``nvme``) and the ``aio`` block, gradient
clipping, gradient prescaling, ``steps_per_print``, the
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

#: top-level keys of the JAX config whose features are not ported, by item
UNPORTED_KEYS = {
    "mesh": "item 11", "comm_overlap": "item 11", "communication_data_type": "item 11",
    "comms_logger": "item 9", "tensorboard": "item 9", "wandb": "item 9",
    "csv_monitor": "item 9", "jsonl_monitor": "item 9", "flops_profiler": "item 9",
    "wall_clock_breakdown": "item 9", "memory_breakdown": "item 9", "dump_state": "item 9",
    "disable_allgather": "item 12", "fp16_master_weights_and_gradients": "item 12",
    "pipeline": "item 13", "sparse_gradients": "item 13", "progressive_layer_drop": "item 13",
    "eigenvalue": "item 13", "elasticity": "item 13", "compression_training": "item 13",
    "quantize_training": "item 13", "data_efficiency": "item 13",
    "curriculum_learning": "item 13", "autotuning": "item 13",
}
ADAM_TYPES = ("adam", "adamw", "fusedadam")
LAMB_TYPES = ("lamb", "fusedlamb")
ONEBIT_TYPES = ("onebitadam", "zerooneadam", "onebitlamb")
OPTIMIZERS = ADAM_TYPES + ("adagrad",) + LAMB_TYPES + ONEBIT_TYPES
_ITEM12B = "item 12b"


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
        if self.loss_scale < 0 or self.initial_scale_power < 0 or self.hysteresis < 0 \
                or self.loss_scale_window <= 0 or self.min_loss_scale < 0:
            raise DeepSpeedConfigError(f"invalid fp16 block {self}")
        _refuse_unread(self, "fp16", [f.name for f in dataclasses.fields(self)
                                      if f.name != "auto_cast"])

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False


def _refuse_unread(block, where: str, read) -> None:
    """The JAX config takes these keys and its engine never reads them: set
    away from their defaults they are refused, as the ``checkpoint`` block's
    are."""
    unread = [f.name for f in dataclasses.fields(block)
              if f.name not in read and getattr(block, f.name) != f.default]
    if unread:
        raise NotImplementedError(
            f"{where} keys {unread} are not read by the JAX engine either (it accepts and "
            "ignores them); set away from their defaults they are refused")


@dataclasses.dataclass
class OffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (JAX
    ``DeepSpeedZeroOffloadOptimizerConfig``): ``device`` none | cpu | nvme, and
    the moment files' directory for nvme."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False

    def __post_init__(self):
        if self.device not in ("none", "cpu", "nvme"):
            raise DeepSpeedConfigError(f"offload_optimizer.device must be none, cpu or nvme, "
                                       f"got {self.device!r}")
        if self.device == "nvme" and not self.nvme_path:
            raise DeepSpeedConfigError("offload_optimizer.device=nvme requires nvme_path")
        _refuse_unread(self, "zero_optimization.offload_optimizer", ("device", "nvme_path"))

    @property
    def enabled(self) -> bool:
        return self.device != "none"


@dataclasses.dataclass
class ZeroConfig:
    """``zero_optimization`` (JAX ``runtime/zero/config.py``). Stages 0-3 are
    taken: on one card the partitions are whole, so a stage changes nothing
    (as on a one-device JAX mesh). ``offload_optimizer`` (or the deprecated
    ``cpu_offload: true``) moves the f32 masters and the optimizer state to
    the host. ``offload_param`` and ``stage3_param_persistence_threshold``
    (read by JAX's partition specs only) raise set (item 12b); so does every
    other key the JAX engine takes but never reads, set away from its
    default."""
    stage: int = 0
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    cpu_offload: Optional[bool] = None
    offload_param: Optional[dict] = None
    cpu_offload_param: Optional[bool] = None
    # read by JAX's partition specs only (item 12b): refused away from its default
    stage3_param_persistence_threshold: int = int(1e5)
    # taken and never read by the JAX engine
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    sub_group_size: int = int(1e9)
    cpu_offload_use_pin_memory: Optional[bool] = None
    stage3_prefetch_bucket_size: int = int(5e7)
    stage3_model_persistence_threshold: int = int(1e15)
    stage3_max_live_parameters: int = int(1e9)
    stage3_max_reuse_distance: int = int(1e9)
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, "
                                       f"got {self.stage}")
        if (self.offload_param and (self.offload_param.get("device") or "none") != "none") \
                or self.cpu_offload_param:
            raise _unported("zero_optimization.offload_param (ZeRO-3 parameter offload)",
                            _ITEM12B)
        if self.stage3_param_persistence_threshold != int(1e5):
            raise _unported("zero_optimization.stage3_param_persistence_threshold (read by "
                            "the ZeRO-3 partition specs)", _ITEM12B)
        if self.offload_optimizer is None and self.cpu_offload:
            self.offload_optimizer = OffloadOptimizerConfig(device="cpu")
        elif isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = from_dict(OffloadOptimizerConfig, self.offload_optimizer,
                                               "zero_optimization.offload_optimizer")
        self.offload_optimizer = self.offload_optimizer or OffloadOptimizerConfig()
        _refuse_unread(self, "zero_optimization",
                       ("stage", "offload_optimizer", "cpu_offload", "offload_param",
                        "cpu_offload_param", "stage3_param_persistence_threshold"))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ZeroConfig":
        data = dict(data)
        for key in [k for k in data if k in _ZERO_ALIASES]:
            data[_ZERO_ALIASES[key]] = data.pop(key)
        return from_dict(cls, data, "zero_optimization")


#: JAX's field names for the stage-3 keys (it takes either spelling)
_ZERO_ALIASES = {k[len("stage3_"):]: k for k in (
    "stage3_param_persistence_threshold", "stage3_prefetch_bucket_size",
    "stage3_model_persistence_threshold", "stage3_max_live_parameters",
    "stage3_max_reuse_distance", "stage3_gather_16bit_weights_on_model_save")}


@dataclasses.dataclass
class AIOConfig:
    """The ``aio`` block (JAX ``AIOConfig``). The engine passes
    ``thread_count``, ``block_size`` and ``queue_depth`` to the NVMe tier's
    handle, as the JAX engine does; the other two it never reads."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True

    def __post_init__(self):
        if self.block_size <= 0 or self.queue_depth <= 0 or self.thread_count <= 0:
            raise DeepSpeedConfigError(f"invalid aio block {self}")
        _refuse_unread(self, "aio", ("block_size", "queue_depth", "thread_count"))


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
        _refuse_unread(self, "checkpoint", ("async_save",))


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
    """An optimizer's hyperparameters (``optimizer.params``), with the JAX
    engine's defaults (``engine.py:_parse_optimizer_config``): LAMB's and 1-bit
    LAMB's trust-ratio bounds, and the 1-bit optimizers' keys that JAX reads
    from its ``extra`` dict."""
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: Optional[bool] = None       # default: True for adamw
    bias_correction: bool = True
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    freeze_step: int = 100                   # onebitadam, onebitlamb
    var_freeze_step: int = 100000            # zerooneadam
    var_update_scaler: int = 16              # zerooneadam

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
             "activation_checkpointing", "aio", "dataloader_drop_last")

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
        self.zero_config = ZeroConfig.from_dict(pd.get("zero_optimization") or {})
        self.aio_config = from_dict(AIOConfig, pd.get("aio") or {}, "aio")
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
            if self.optimizer_name not in (None,) + OPTIMIZERS:
                raise ValueError(f"unknown optimizer {name!r} (ported: {OPTIMIZERS})")
            if self.optimizer_name == "adagrad" and "eps" not in params:
                params = {**params, "eps": 1e-10}      # JAX engine.py:244
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
        self.dataloader_drop_last: bool = bool(pd.get("dataloader_drop_last", False))

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
