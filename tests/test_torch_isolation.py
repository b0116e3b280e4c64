"""The port stands alone: it imports no JAX, flax, pydantic or ``deepspeed_tpu``.

The card's machine has none of them, so any such import in
``deepspeed_tpu_torch/``, ``chip_smoke.py``, the card-only test or the
timing scripts of ``benchmarks/torch/`` would break them there.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pydantic", "deepspeed_tpu")


def _port_files():
    # the card-only test and the timing scripts run on the card's machine too
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_kernels_cuda.py")]
    files += [os.path.join(REPO, "benchmarks", "torch", n)
              for n in ("dq_ties.py", "offload_6p7b.py", "offload_parity.py",
                        "qmm_versions.py", "train_features.py", "train_versions.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "deepspeed_tpu_torch")):
        dirs.sort()                     # one order for every xdist worker
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.ops.kernel_checks, "
            "deepspeed_tpu_torch.inference.speculative, deepspeed_tpu_torch.checkpoint, "
            "deepspeed_tpu_torch.module_inject, deepspeed_tpu_torch.utils.zero_to_fp32, "
            "deepspeed_tpu_torch.runtime.zero.offload, deepspeed_tpu_torch.ops.aio.aio_handle, "
            "deepspeed_tpu_torch.runtime.fp16.onebit, deepspeed_tpu_torch.ops.lamb, "
            "deepspeed_tpu_torch.runtime.dataloader, deepspeed_tpu_torch.runtime.rng, "
            "deepspeed_tpu_torch.moe.layer, deepspeed_tpu_torch.models.gpt2_moe; "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
