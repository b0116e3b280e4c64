from .aio_handle import AsyncIOHandle, aligned_array, padded_len  # noqa: F401
