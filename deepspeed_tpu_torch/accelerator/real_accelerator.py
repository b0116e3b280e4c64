"""Accelerator resolution: ``get_accelerator()`` and the one device rule every
entry point shares (``resolve_device``)."""

from typing import Optional, Union

import torch

_accelerator = None


def get_accelerator():
    global _accelerator
    if _accelerator is None:
        from .cuda_accelerator import CUDA_Accelerator
        _accelerator = CUDA_Accelerator()
    return _accelerator


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as given, else ``cuda:0``. Never picks the CPU on its own: with no
    device given and no CUDA present it raises, so a caller that wants the CPU
    (the tests) says so with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda", 0)
