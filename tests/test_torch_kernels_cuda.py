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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_flash_fwd_refuses_autograd_on_card():
    """The forward kernel's output has no autograd history, so the wrapper
    refuses inputs that require grad while grad mode is on."""
    from deepspeed_tpu_torch.ops.attention.flash import flash_fwd
    q = torch.randn(4, 128, 64, device=_card(), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="FlashAttnFunction"):
        flash_fwd(q, q, q)
    with torch.no_grad():
        flash_fwd(q, q, q)


def test_flash_attention_gradients_on_card():
    """flash_attention on the card (forward kernel, then both backward
    kernels through FlashAttnFunction) against flash_bwd_plain fed with the
    forward kernel's o and lse on the same inputs, bf16, within the backward
    kernels' bf16 tolerance. The plain forward rounds o to bf16 at other
    points, and delta = rowsum(do * o) would carry that into every ds."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.attention.flash import (flash_attention, flash_bwd_plain,
                                                         flash_fwd)
    device = _card()
    b, t, h, d = 2, 300, 4, 64
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    op_builder.reset_launch_counts()
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    counts = op_builder.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1)

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    q3, k3, v3, do3 = map(to3, (q, k, v, do))
    with torch.no_grad():
        o3, lse = flash_fwd(q3, k3, v3, None, None, True, h)
    want = flash_bwd_plain(q3, k3, v3, o3, lse, do3, None, d ** -0.5, True, h)
    atol, rtol = kernel_checks.BWD_TOLERANCES[torch.bfloat16]
    for g, w in zip(got, want):
        ratio = kernel_checks.err_ratio(to3(g), w, atol, rtol)
        assert ratio <= 1.0, ratio


def test_refused_launch_raises():
    """A launch the entry point refuses (more than 65535 row blocks) comes back
    as a CUDA error code and is raised, never dropped."""
    from deepspeed_tpu_torch.ops.attention.flash import flash_bwd_dkv, flash_bwd_dq
    from deepspeed_tpu_torch.ops.op_builder import KernelLaunchError
    device = _card()
    q = torch.zeros(65536, 1, 64, device=device, dtype=torch.bfloat16)
    rows = torch.zeros(65536, 1, device=device)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(KernelLaunchError, match="invalid argument"):
            fn(q, q, q, q, rows, rows)
