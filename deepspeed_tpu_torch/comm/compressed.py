"""Error-compensated 1-bit (sign) compression.

Counterpart of ``sign_compress`` in ``deepspeed_tpu/comm/compressed.py``, the
unpacked core the 1-bit optimizers use for their momentum. The wire forms
(bit packing, the compressed allreduce) wait for data parallelism
(ROADMAP.md queue 1 item 11).
"""

from typing import Tuple

import torch


def sign_compress(x: torch.Tensor, error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(compressed, new_error)`` with ``compressed + new_error == x + error``:
    with ``c = x + error`` and ``scale = mean(|c|)``, ``compressed`` is
    ``+scale`` where ``c >= 0`` and ``-scale`` elsewhere."""
    c = x + error
    scale = c.abs().mean()
    compressed = torch.where(c >= 0, scale, -scale)
    return compressed, c - compressed
