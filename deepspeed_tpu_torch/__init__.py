"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

It trains a model through ``initialize(model=..., config=...)`` and
``engine.train_batch(batch)``, and serves a causal LM through
``init_inference(model, config)`` and ``engine.generate(...)`` (in bf16, or
with int8/int4 weights), on one NVIDIA card, with hand-written Hopper kernels:
the flash forward and its two backward kernels, dense and paged decode
attention, and the dequant-GEMM of quantized projections. It imports torch, numpy and the
standard library only; the JAX package stays beside it as the reference. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import DeepSpeedConfig  # noqa: F401
from .inference import DeepSpeedInferenceConfig, InferenceEngine  # noqa: F401
from .runtime.activation_checkpointing import checkpointing  # noqa: F401
from .runtime.engine import DeepSpeedEngine  # noqa: F401
from .utils.logging import logger  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Create a training engine for a :class:`~.models.base.Model` (e.g.
    ``models.gpt2_model(cfg)``) from a config dict, a :class:`DeepSpeedConfig`
    or a ``.json`` path (``config``, ``config_params`` or
    ``args.deepspeed_config``). Returns ``(engine, optimizer, None,
    lr_scheduler)``, as DeepSpeed's ``initialize`` does; the third item is the
    dataloader, which is not ported (ROADMAP.md queue 1 item 5). ``device``
    defaults to ``cuda:0`` and raises where there is no CUDA."""
    config = config if config is not None else config_params
    if config is None and getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config
    if config is None:
        raise ValueError("initialize needs config= (or config_params=, or "
                         "args.deepspeed_config)")
    if type(model).__name__ == "PipelineModule":
        raise NotImplementedError("PipelineModule (pipeline parallelism) is not ported yet: "
                                  "ROADMAP.md queue 1 item 13")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters, training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu, collate_fn=collate_fn,
                             config=config, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model, config=None, device=None, **kwargs) -> InferenceEngine:
    """Create an inference engine for a decoder ``CausalLM`` model (a
    ``CausalLMConfig`` or ``(CausalLMConfig, state_dict)``). ``config`` is a
    dict or :class:`DeepSpeedInferenceConfig`; keyword arguments that are not
    None are merged into a dict config. ``device`` defaults to ``cuda:0`` and
    raises where there is no CUDA."""
    if config is None:
        config = {}
    if isinstance(config, dict):
        config = dict(config)
        config.update({k: v for k, v in kwargs.items() if v is not None})
        config = DeepSpeedInferenceConfig.from_dict(config)
    return InferenceEngine(model, config, device=device)
