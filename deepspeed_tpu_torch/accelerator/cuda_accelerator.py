"""The CUDA accelerator: device naming, count and synchronisation for NVIDIA
cards, through ``torch.cuda``."""

from typing import Optional

import torch


class CUDA_Accelerator:
    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index: Optional[int] = None) -> torch.device:
        return torch.device("cuda", device_index or 0)

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def communication_backend_name(self) -> str:
        return "nccl"

    def synchronize(self, device_index: Optional[int] = None):
        torch.cuda.synchronize(device_index)
