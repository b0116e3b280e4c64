from .attention import get_attention_impl, reference_attention  # noqa: F401
