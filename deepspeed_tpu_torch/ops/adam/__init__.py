from .fused_adam import AdamState, fused_adam, fused_adamw  # noqa: F401
