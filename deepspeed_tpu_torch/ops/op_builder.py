"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. Libraries are named by a hash of their sources and
flags and kept under ``build/torch_kernels/`` beside the package (override with
``DS_TORCH_BUILD_DIR``), so a changed source builds anew and an unchanged one is
reused. Nothing is built at import: the first launch builds its kernel, and
:func:`build` builds several at once, one ``nvcc`` per source, all started
together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises if that is not 0, since
a refused launch never runs and a later synchronise does not report it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: every kernel the port defines, by name; ``chip_smoke.py`` zeroes and reads
#: their launch counts around the main path
KERNELS: Dict[str, "CudaKernel"] = {}

_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def build_dir() -> str:
    return os.environ.get("DS_TORCH_BUILD_DIR") or os.path.join(
        _REPO_DIR, "build", "torch_kernels")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(source: str) -> str:
    """``build_dir()/<stem>-<hash>.so``; the hash covers the source, every
    header in ``csrc/`` and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"{stem}-{h.hexdigest()[:16]}.so")


def build(sources: Iterable[str]) -> Dict[str, float]:
    """Compile each ``csrc/`` source whose library is missing, one ``nvcc`` per
    source, all running at once. Returns the seconds each build took (sources
    already built are left out). Raises :class:`KernelBuildError` with the
    compiler's output if any build fails; waits for every ``nvcc`` it started."""
    os.makedirs(build_dir(), exist_ok=True)
    started = []
    t0 = time.perf_counter()
    for source in dict.fromkeys(sources):
        so = _library_path(source)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((source, so, tmp, proc))
    seconds, failed = {}, []
    for source, so, tmp, proc in started:
        out, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return seconds


class CudaKernel:
    """One hand-written kernel: its source in ``csrc/``, its C entry point and
    that entry point's ``argtypes`` (``c_void_p`` for every pointer and for the
    stream), and ``launches``, the number of launches since the count was last
    set to 0."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None
        KERNELS[name] = self

    def _load(self):
        with _lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(_library_path(self.source))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.ds_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        code = fn(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise KernelLaunchError(f"{self.name}: launch failed with CUDA error "
                                    f"{code} ({msg})")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
