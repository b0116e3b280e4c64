"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

It serves a causal LM through ``init_inference(model, config)`` and
``engine.generate(...)`` on one NVIDIA card, with hand-written Hopper kernels
for prefill (flash attention) and decode attention. It imports torch, numpy and
the standard library only; the JAX package stays beside it as the reference.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .inference import DeepSpeedInferenceConfig, InferenceEngine  # noqa: F401
from .utils.logging import logger  # noqa: F401


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
