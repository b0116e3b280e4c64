"""Inference configuration: ``DeepSpeedInferenceConfig`` as a strict dataclass.

Same key names as ``deepspeed_tpu/inference/config.py`` (and so as DeepSpeed's
own), built from a dict. An unknown key raises ``ValueError``; a key whose
feature this package does not serve yet, set to anything but its default,
raises ``NotImplementedError`` naming the ``ROADMAP.md`` queue item that ports it.
"""

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..config.config_utils import from_dict as _from_dict
from ..models.causal_lm import check_moe_decode_impl

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclasses.dataclass
class DeepSpeedTPConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclasses.dataclass
class QuantConfig:
    enabled: bool = False
    bits: int = 8


@dataclasses.dataclass
class WeightQuantConfig:
    """Weight-streaming quantized serving: the projections (``QUANT_NAMES`` of
    ``models/causal_lm.py``) are stored grouped-quantized and run in the
    dequant-GEMM kernel; embeddings, norms, biases and the head stay fp.
    ``bits`` 8 or 4; ``group`` rows a scale group; ``exclude`` parameter-path
    substrings (JAX paths, e.g. ``"layers_0/"``, ``"fc_out"``) kept fp;
    ``outlier_threshold`` the audit's relative-error bound, None for the
    per-bits default (:meth:`resolved_threshold`)."""
    enabled: bool = False
    bits: int = 8
    group: int = 128
    exclude: List[str] = dataclasses.field(default_factory=list)
    outlier_threshold: Optional[float] = None

    def resolved_threshold(self) -> float:
        if self.outlier_threshold is not None:
            return float(self.outlier_threshold)
        return 0.05 if self.bits == 8 else 0.30


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(default_factory=DeepSpeedTPConfig)
    data_parallel: int = 1
    max_out_tokens: int = 1024
    max_batch_size: int = 1
    replace_with_kernel_inject: bool = True
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    weight_quant: WeightQuantConfig = dataclasses.field(default_factory=WeightQuantConfig)
    checkpoint: Optional[Any] = None
    replace_method: str = "auto"
    enable_cuda_graph: bool = False
    min_out_tokens: int = 1
    # overrides the model's moe_decode_impl: "pallas" (the kernel) or "xla"
    moe_decode_impl: Optional[str] = None
    comm_overlap: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mp_size: Optional[int] = None                 # deprecated alias of tensor_parallel.tp_size

    def __post_init__(self):
        self.tensor_parallel = _from_dict(DeepSpeedTPConfig, self.tensor_parallel,
                                          "tensor_parallel")
        self.quant = _from_dict(QuantConfig, self.quant, "quant")
        self.weight_quant = _from_dict(WeightQuantConfig, self.weight_quant, "weight_quant")
        key = str(self.dtype).replace("torch.", "")
        if key != "int8" and key not in _DTYPES:
            raise ValueError(f"dtype={self.dtype!r} is not one of "
                             f"{sorted(_DTYPES) + ['int8']}")
        if self.resolved_tp() > 1:
            raise NotImplementedError("tensor parallelism (tp_size > 1) is not ported yet: "
                                      "ROADMAP.md queue 1 item 11")
        if int(self.data_parallel) > 1:
            raise NotImplementedError("data_parallel > 1 is not ported yet: "
                                      "ROADMAP.md queue 1 item 11")
        if self.comm_overlap:
            raise NotImplementedError("comm_overlap is not ported yet: "
                                      "ROADMAP.md queue 1 item 11")
        if self.moe_decode_impl is not None:
            # fails at construction, before any model is built ('triton', 'XLA')
            check_moe_decode_impl(self.moe_decode_impl)
        if self.checkpoint is not None:
            # the JAX config accepts the key and its engine never reads it
            raise NotImplementedError("the inference config's checkpoint key is not read, "
                                      "as in the JAX package: load a training tag with "
                                      "InferenceEngine.load_checkpoint(ckpt_dir, tag)")
        if self.enable_cuda_graph:
            raise NotImplementedError("CUDA-graph capture of the decode step is not "
                                      "ported yet: ROADMAP.md queue 1 item 3")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeepSpeedInferenceConfig":
        return _from_dict(cls, data, "inference config")

    def resolved_tp(self) -> int:
        if self.mp_size is not None:
            return int(self.mp_size)
        return int(self.tensor_parallel.tp_size)

    def is_int8(self) -> bool:
        """int8 serving: int8-quantized weights and bf16 compute, spelled
        ``dtype="int8"`` or with the legacy ``quant`` block."""
        return str(self.dtype).replace("torch.", "") == "int8" or self.quant.enabled

    def resolved_weight_quant(self) -> WeightQuantConfig:
        """One weight-quantization surface: the ``weight_quant`` block wins;
        the legacy ``quant`` block and ``dtype="int8"`` resolve to its 8-bit
        defaults."""
        if self.weight_quant.enabled:
            return self.weight_quant
        if self.is_int8():
            return WeightQuantConfig(enabled=True, bits=8)
        return self.weight_quant

    def torch_dtype(self) -> torch.dtype:
        """The compute dtype; ``"int8"`` computes in bf16 (its weights are
        quantized separately)."""
        key = str(self.dtype).replace("torch.", "")
        return torch.bfloat16 if key == "int8" else _DTYPES[key]
