"""Model conversion for serving.

Counterpart of ``deepspeed_tpu/module_inject/``. Ported so far:
``convert_training_model`` (serve what the GPT-2 trainer produced). The
Hugging Face policies (``convert_hf_model``, ``auto_tp``, the encoder and
diffusers policies) are ROADMAP.md queue 1 item 4.
"""

from .replace_module import convert_training_model  # noqa: F401
