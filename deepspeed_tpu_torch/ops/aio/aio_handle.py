"""Async file I/O for the NVMe tier of ZeRO-Offload.

Counterpart of ``deepspeed_tpu/ops/aio/aio_handle.py`` (the reference's
``deepspeed_aio_handle_t``), on contiguous CPU tensors: submit reads and
writes of a tensor's bytes against files, overlap them with host compute, and
``wait()`` for the batch. Backed by ``csrc/aio/deepspeed_aio.cpp``, a copy of
the JAX package's thread-pool op, built by ``op_builder.load_host_op``; a failed
build raises.

O_DIRECT (page-cache bypass, for moment stores larger than RAM) needs
4096-aligned buffers, offsets and lengths: :func:`aligned_array` and
:func:`padded_len` give them. A filesystem that refuses O_DIRECT (tmpfs) makes
the handle fall back to buffered I/O for that file, with a warning, as JAX's
does; ``direct_refused`` records that it happened.
"""

import ctypes
import functools

import torch

from ...utils.logging import logger
from ..op_builder import load_host_op

O_DIRECT_ALIGN = 4096
# errnos meaning "this filesystem does not support O_DIRECT" (an unrelated open
# failure such as ENOENT surfaces through the buffered retry)
_DIRECT_REFUSED = (22, 95)   # EINVAL, EOPNOTSUPP


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_host_op("aio/deepspeed_aio.cpp", extra_flags=("-lpthread",))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ds_aio_handle_new.argtypes = [ctypes.c_int, i64]
    lib.ds_aio_handle_new.restype = p
    lib.ds_aio_handle_free.argtypes = [p]
    lib.ds_aio_handle_free.restype = None
    for fn in (lib.ds_aio_open, lib.ds_aio_open_direct):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.ds_aio_close.argtypes = [ctypes.c_int]
    lib.ds_aio_close.restype = None
    for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite):
        fn.argtypes = [p, ctypes.c_int, p, i64, i64]
        fn.restype = None
    lib.ds_aio_wait.argtypes = [p]
    lib.ds_aio_wait.restype = i64
    return lib


def aligned_array(n_bytes: int, dtype: torch.dtype = torch.uint8,
                  align: int = O_DIRECT_ALIGN) -> torch.Tensor:
    """A contiguous CPU tensor of ``ceil(n_bytes / align) * align`` bytes whose
    data pointer is ``align``-aligned (the view keeps its over-allocated
    storage alive)."""
    padded = -(-n_bytes // align) * align
    raw = torch.empty(padded + align, dtype=torch.uint8)
    shift = (-raw.data_ptr()) % align
    return raw[shift:shift + padded].view(dtype)


def padded_len(n_elems: int, itemsize: int, align: int = O_DIRECT_ALIGN) -> int:
    """The element count whose byte length rounds ``n_elems * itemsize`` up to
    ``align``."""
    return (-(-(n_elems * itemsize) // align) * align) // itemsize


class AsyncIOHandle:
    """``async_pread``/``async_pwrite``/``wait`` and the sync wrappers. A
    buffer must be a contiguous CPU tensor left unchanged until ``wait()``
    returns; the handle holds a reference to it until then. ``thread_count``
    is the concurrency and ``block_size`` the chunk of one ``pread`` or
    ``pwrite``; ``queue_depth`` tunes libaio's batching in the reference,
    which the thread pool does not have, so it is kept and not used, as in
    JAX."""

    def __init__(self, thread_count: int = 1, block_size: int = 1 << 20,
                 queue_depth: int = 8, o_direct: bool = False):
        self._lib = _lib()
        self.o_direct = bool(o_direct)
        if self.o_direct:
            # every chunk after the first starts at a multiple of block_size
            block_size = max(O_DIRECT_ALIGN,
                             int(block_size) // O_DIRECT_ALIGN * O_DIRECT_ALIGN)
        self.thread_count, self.block_size, self.queue_depth = (int(thread_count),
                                                                int(block_size),
                                                                int(queue_depth))
        self._h = self._lib.ds_aio_handle_new(self.thread_count, self.block_size)
        self._fds = {}
        self._inflight = []       # the buffers the worker threads may still touch
        self.direct_refused = False

    def _fd(self, path: str, write: bool) -> int:
        key = (path, write)
        if key not in self._fds:
            fd = -1
            if self.o_direct:
                fd = self._lib.ds_aio_open_direct(path.encode(), int(write))
                if fd < 0 and -fd in _DIRECT_REFUSED and not self.direct_refused:
                    logger.warning(f"aio: filesystem refused O_DIRECT for {path}; "
                                   "falling back to buffered IO")
                    self.direct_refused = True
            if fd < 0:
                fd = self._lib.ds_aio_open(path.encode(), int(write))
            if fd < 0:
                raise OSError(f"aio: cannot open {path} (write={write})")
            self._fds[key] = fd
        return self._fds[key]

    @staticmethod
    def _buf(t: torch.Tensor):
        if not isinstance(t, torch.Tensor) or t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors")
        return t.data_ptr(), t.numel() * t.element_size()

    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        ptr, nbytes = self._buf(t)
        self._inflight.append(t)
        self._lib.ds_aio_pread(self._h, self._fd(path, False), ptr, nbytes, offset)

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        ptr, nbytes = self._buf(t)
        self._inflight.append(t)
        self._lib.ds_aio_pwrite(self._h, self._fd(path, True), ptr, nbytes, offset)

    def wait(self) -> int:
        """Block until every submitted op is done; raises ``OSError`` if any
        failed (a short read at end of file included)."""
        errors = self._lib.ds_aio_wait(self._h)
        self._inflight.clear()
        if errors:
            raise OSError(f"aio: {errors} I/O operations failed")
        return 0

    def sync_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        self.async_pread(t, path, offset)
        self.wait()

    def sync_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        self.async_pwrite(t, path, offset)
        self.wait()

    def close(self) -> None:
        """Wait for what is in flight, close the files and free the pool."""
        if self._h is not None:
            self._lib.ds_aio_wait(self._h)
            self._inflight.clear()
            for fd in self._fds.values():
                self._lib.ds_aio_close(fd)
            self._fds.clear()
            self._lib.ds_aio_handle_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()
