from .attention import reference_attention  # noqa: F401
