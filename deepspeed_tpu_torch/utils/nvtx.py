"""Profiler range annotation.

Counterpart of ``deepspeed_tpu/utils/nvtx.py`` (``annotate``): where the JAX
package opens a ``jax.profiler.TraceAnnotation``, the port opens a real NVTX
range (``torch.cuda.nvtx``), which ``torch.profiler`` and Nsight show on the
host lane beside the kernels the region launched. Without CUDA it does
nothing.
"""

import contextlib

import torch


def annotate(name: str):
    """Host-side profiler range around a dispatch (context manager)."""
    if not torch.cuda.is_available():
        return contextlib.nullcontext()
    return torch.cuda.nvtx.range(name)
