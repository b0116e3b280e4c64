from .real_accelerator import get_accelerator, resolve_device  # noqa: F401
