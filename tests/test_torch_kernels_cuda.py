"""The port's CUDA kernels against their plain versions, on the card.

Runs the cases of ``deepspeed_tpu_torch/ops/kernel_checks.py`` (shapes and
tolerances shared with ``chip_smoke.py``). The kernels have no CPU mode, so
without a CUDA card each case skips. This file imports no JAX, so it also
runs on the card's machine, which has none; there ``tests/conftest.py``
(which imports JAX) is left out:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import kernel_checks


@pytest.mark.parametrize("case", kernel_checks.CASES,
                         ids=lambda c: f"{c.kernel}-{c.name}")
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kernel_checks.check(case, torch.device("cuda", 0))
