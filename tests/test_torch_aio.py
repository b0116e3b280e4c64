"""The port's async file I/O handle (``deepspeed_tpu_torch/ops/aio``) on the CPU.

The cases of the JAX package's ``tests/unit/ops/test_aio.py`` on CPU tensors:
round trips, many ops under one ``wait``, offsets, the read error, the aligned
buffers and O_DIRECT with its buffered fallback. Files written by either
package's handle read back equal through the other's, from the same seeded
numpy data: both build one C++ source.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.aio import aio_handle as jax_aio
from deepspeed_tpu_torch.ops.aio import aio_handle as aio


def _data(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_write_read_roundtrip_and_jax_reads_it(tmp_path):
    h = aio.AsyncIOHandle(thread_count=2)
    data = _data(100_000)
    path = str(tmp_path / "buf.bin")
    h.sync_pwrite(torch.from_numpy(data), path)
    out = torch.empty(data.size)
    h.sync_pread(out, path)
    np.testing.assert_array_equal(out.numpy(), data)
    jh = jax_aio.AsyncIOHandle(thread_count=2)
    jout = np.empty_like(data)
    jh.sync_pread(jout, path)
    np.testing.assert_array_equal(jout, data)
    jh.sync_pwrite(data[::-1].copy(), str(tmp_path / "jax.bin"))
    h.sync_pread(out, str(tmp_path / "jax.bin"))
    np.testing.assert_array_equal(out.numpy(), data[::-1])
    jh.close()
    h.close()


def test_async_batch_overlap(tmp_path):
    """Many ops in flight across files complete under one wait()."""
    h = aio.AsyncIOHandle(thread_count=4)
    for i in range(8):
        h.async_pwrite(torch.full((50_000,), float(i)), str(tmp_path / f"f{i}.bin"))
    h.wait()
    outs = [torch.empty(50_000) for _ in range(8)]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    h.wait()
    for i, o in enumerate(outs):
        assert torch.equal(o, torch.full((50_000,), float(i)))
    h.close()


def test_offset_io(tmp_path):
    h = aio.AsyncIOHandle()
    base = torch.arange(1000, dtype=torch.float32)
    path = str(tmp_path / "off.bin")
    h.sync_pwrite(base, path)
    tail = torch.empty(500)
    h.sync_pread(tail, path, offset=500 * 4)
    assert torch.equal(tail, base[500:])
    h.sync_pwrite(torch.full((100,), -1.0), path, offset=200 * 4)
    full = torch.empty(1000)
    h.sync_pread(full, path)
    assert torch.equal(full[200:300], torch.full((100,), -1.0))
    assert torch.equal(full[:200], base[:200]) and torch.equal(full[300:], base[300:])
    h.close()


def test_read_errors_raise(tmp_path):
    h = aio.AsyncIOHandle()
    with pytest.raises(OSError):
        h.sync_pread(torch.empty(10), str(tmp_path / "missing.bin"))
    h.sync_pwrite(torch.zeros(10), str(tmp_path / "short.bin"))
    with pytest.raises(OSError, match="failed"):          # a read past the end of the file
        h.sync_pread(torch.empty(20), str(tmp_path / "short.bin"))
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pwrite(torch.zeros(4, 4).t(), str(tmp_path / "x.bin"))
    h.close()


def test_aligned_array_contract():
    a = aio.aligned_array(10_000, torch.float32)
    assert a.data_ptr() % aio.O_DIRECT_ALIGN == 0 and a.dtype == torch.float32
    assert (a.numel() * 4) % aio.O_DIRECT_ALIGN == 0 and a.numel() * 4 >= 10_000
    for n, itemsize in ((1000, 4), (1024, 4), (1, 2), (4097, 1)):
        assert aio.padded_len(n, itemsize) == jax_aio.padded_len(n, itemsize)
        assert aio.padded_len(n, itemsize) * itemsize % aio.O_DIRECT_ALIGN == 0
    assert aio.padded_len(1024, 4) == 1024


def test_direct_roundtrip_or_visible_fallback(tmp_path):
    """O_DIRECT where the filesystem takes it; where it refuses (tmpfs), the
    buffered fallback is taken and recorded, as JAX's handle does."""
    h = aio.AsyncIOHandle(thread_count=2, block_size=5000, o_direct=True)
    assert h.block_size == 4096           # chunk boundaries stay 4096-aligned
    n = 1 << 20
    src = aio.aligned_array(n)
    src.copy_(torch.from_numpy(np.arange(n, dtype=np.uint64).view(np.uint8)[:n].copy()))
    dst = aio.aligned_array(n)
    f = str(tmp_path / "direct.bin")
    h.sync_pwrite(src, f)
    h.sync_pread(dst, f)
    assert torch.equal(dst, src)
    jh = jax_aio.AsyncIOHandle(o_direct=True)
    jdst = jax_aio.aligned_array(n)
    jh.sync_pread(jdst, f)
    np.testing.assert_array_equal(jdst, src.numpy())
    assert h.direct_refused == jh._direct_warned
    jh.close()
    h.close()
