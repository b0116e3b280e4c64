from .fused_lamb import LambState, fused_lamb, trust_ratio  # noqa: F401
