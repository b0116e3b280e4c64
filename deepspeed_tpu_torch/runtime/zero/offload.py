"""ZeRO-Offload: the optimizer tier in host memory.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``, for one process.
The f32 masters and the optimizer state (Adam's moments, or Adagrad's
squared-gradient sums) live in host memory as flat f32 CPU tensors, pinned
when the device is CUDA; the device keeps only compute-dtype parameters and
the gradient accumulator, so its per-parameter state drops from 16 bytes (f32
master, two moments, gradient) to the compute-dtype copy and the gradient.

A step (:meth:`OffloadOptimizerTier.step`):

1. the gradients, already unscaled, clipped and cast to the transfer dtype on
   the device (bf16 for bf16 runs, f32 otherwise), go to pinned host buffers
   in one non-blocking copy each; the host waits on one event recorded after
   them, not on a device-wide synchronise;
2. the C++ step (``ops/adam/cpu_adam.py``) updates one leaf at a time in
   place, and right after each leaf's update that leaf is cast to the compute
   dtype (``fp32_to_bf16`` into a pinned staging buffer, or ``.to(float16)``)
   and pushed to the device without blocking, so the copy of leaf ``i`` runs
   while leaf ``i + 1`` updates (JAX's interleave, ``offload.py:400-418``).

With ``nvme_path`` Adam's moments live in files there instead
(:class:`_NVMeMomentStore`, ZeRO-Infinity's moment swap), streamed through two
4096-aligned scratch buffers by the async I/O handle (``ops/aio``): leaf
``i + 1``'s moments are read while leaf ``i`` updates.

Checkpoints keep JAX's names and layout: ``masters`` / ``m`` / ``v`` /
``sq_sum`` keyed ``leaf{i}``, ``shapes`` and ``step``; the NVMe tier saves its
masters and step, and copies its moment files to ``<path>_moments``.

Several processes (JAX's ``_partitioned`` tier, each process holding the
master shards of its devices) wait for data parallelism, ROADMAP.md queue 1
item 11.
"""

import os
import shutil
import time
from typing import Dict, List, Optional, Sequence

import torch

from ...ops.adam.cpu_adam import (DeepSpeedCPUAdam, adagrad_step, adam_step, as_f32,
                                  fp32_to_bf16)
from ...ops.aio.aio_handle import AsyncIOHandle, aligned_array, padded_len
from ...utils.logging import log_dist


def _process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def cast_master_to(flat: torch.Tensor, shape, compute_dtype: torch.dtype,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An f32 host master (flat) in the compute dtype, shaped for the push:
    bf16 through the C++ cast, other dtypes through ``copy_``; into ``out``
    (a flat staging buffer) when given. f32 needs no cast: the master itself."""
    if compute_dtype == torch.bfloat16:
        return fp32_to_bf16(flat, out).view(shape)
    if compute_dtype == torch.float32:
        return flat.view(shape)
    if out is None:
        return flat.to(compute_dtype).view(shape)
    return out.copy_(flat).view(shape)


def make_swap_handle(path: str, aio_config: dict, feature: str) -> AsyncIOHandle:
    """The NVMe store's directory and its async I/O handle, always O_DIRECT
    (the handle falls back to buffered I/O, with a warning, where the
    filesystem refuses it). ``feature`` names the setting in an error."""
    if not path:
        raise ValueError(f"{feature} needs a directory (nvme_path)")
    os.makedirs(path, exist_ok=True)
    return AsyncIOHandle(thread_count=aio_config.get("thread_count", 1),
                         block_size=aio_config.get("block_size", 1 << 20),
                         queue_depth=aio_config.get("queue_depth", 8),
                         o_direct=True)


class _NVMeMomentStore:
    """Adam's moments on disk: one file a leaf under ``path``, m then v (f32),
    its byte length padded to the O_DIRECT granularity. Leaf ``i`` updates in
    scratch buffer ``i % 2`` while leaf ``i + 1``'s moments stream into the
    other. A leaf whose file was never written reads as zeros (no zero pass
    over the disk at start-up, which a resume would overwrite anyway)."""

    def __init__(self, path: str, sizes: Sequence[int], aio_config: dict):
        self.path = path
        self.handle = make_swap_handle(path, aio_config, "offload_optimizer.device=nvme")
        self.sizes = [int(s) for s in sizes]
        self._files = [os.path.join(path, f"moments_leaf{i}.bin")
                       for i in range(len(self.sizes))]
        cap = padded_len(2 * max(self.sizes), 4)
        self._scratch = [aligned_array(cap * 4, torch.float32) for _ in range(2)]
        self._dirty = [False] * len(self.sizes)

    def _io_len(self, i: int) -> int:
        """Leaf ``i``'s file length in f32 elements (4096-byte padded; the pad
        is scratch either way and never read)."""
        return padded_len(2 * self.sizes[i], 4)

    def _fetch(self, i: int, buf: torch.Tensor) -> None:
        if self._dirty[i]:
            self.handle.async_pread(buf[:self._io_len(i)], self._files[i])
        else:
            buf[:2 * self.sizes[i]].zero_()

    def adam_step_all(self, param_f32, grad_f32, lr: float, step: int, betas, eps: float,
                      weight_decay: float, adam_w_mode: bool, bias_correction: bool,
                      on_leaf_done=None) -> None:
        """One Adam step over every leaf, its moments read and written back
        through the handle; ``param_f32(i)`` gives leaf ``i``'s f32 master
        (updated in place), then ``grad_f32(i)`` its f32 gradient, and
        ``on_leaf_done(i)`` runs after its update."""
        n, buf = len(self.sizes), self._scratch
        self._fetch(0, buf[0])
        self.handle.wait()
        for i in range(n):
            if i + 1 < n:                   # the next leaf's moments stream in meanwhile
                self._fetch(i + 1, buf[(i + 1) % 2])
            s, mv = self.sizes[i], buf[i % 2]
            p = param_f32(i)
            adam_step(p, mv[:s], mv[s:2 * s], grad_f32(i), lr, betas[0], betas[1],
                      eps, weight_decay, adam_w_mode, step, bias_correction)
            if on_leaf_done is not None:
                on_leaf_done(i)
            self.handle.async_pwrite(mv[:self._io_len(i)], self._files[i])
            self._dirty[i] = True
            self.handle.wait()

    # --------------------------------------------------------- checkpoints
    def copy_files_to(self, dest_dir: str) -> None:
        """The moments by file copy, never through host memory (a leaf never
        written has no file: it is all zeros)."""
        os.makedirs(dest_dir, exist_ok=True)
        self.handle.wait()
        for i, f in enumerate(self._files):
            if self._dirty[i]:
                shutil.copy2(f, os.path.join(dest_dir, os.path.basename(f)))

    def check_files(self, src_dir: str) -> List[Optional[int]]:
        """Each leaf's saved file size, or None where the tag has no file for
        it; raises before anything is installed if a file has any size but
        the padded length or the unpadded legacy one (a truncated or corrupt
        file would zero or garble the moments)."""
        sizes = []
        for i, f in enumerate(self._files):
            src = os.path.join(src_dir, os.path.basename(f))
            if not os.path.isfile(src):
                sizes.append(None)
                continue
            want, legacy, have = self._io_len(i) * 4, 2 * self.sizes[i] * 4, \
                os.path.getsize(src)
            if have not in (want, legacy):
                raise RuntimeError(f"corrupt moments file {src}: {have} bytes, expected "
                                   f"{want} (or legacy {legacy}); the checkpoint is "
                                   "damaged, restore from the previous 'latest' tag")
            sizes.append(have)
        return sizes

    def copy_files_from(self, src_dir: str, sizes: List[Optional[int]]) -> None:
        """Install the files :meth:`check_files` accepted."""
        self.handle.wait()
        for i, (f, have) in enumerate(zip(self._files, sizes)):
            if have is None:
                # all zeros when saved: the next fetch zero-fills instead of
                # reading this run's own file
                self._dirty[i] = False
                continue
            shutil.copy2(os.path.join(src_dir, os.path.basename(f)), f)
            want = self._io_len(i) * 4
            if have < want:
                with open(f, "ab") as fh:
                    fh.write(b"\0" * (want - have))
            self._dirty[i] = True

    def read_moments(self):
        """Every leaf's (m, v) in host memory: for tests, state dicts and
        exports of models that fit; checkpoints copy the files instead."""
        ms, vs = [], []
        for i, s in enumerate(self.sizes):
            mv = aligned_array(self._io_len(i) * 4, torch.float32)
            mv.zero_()
            if self._dirty[i]:
                self.handle.sync_pread(mv[:self._io_len(i)], self._files[i])
            ms.append(mv[:s].clone())
            vs.append(mv[s:2 * s].clone())
        return ms, vs

    def write_moments(self, ms, vs) -> None:
        for i, (m, v) in enumerate(zip(ms, vs)):
            s = self.sizes[i]
            mv = aligned_array(self._io_len(i) * 4, torch.float32)
            mv[:s] = m.reshape(-1)
            mv[s:2 * s] = v.reshape(-1)
            mv[2 * s:] = 0.0
            self.handle.sync_pwrite(mv[:self._io_len(i)], self._files[i])
            self._dirty[i] = True


class OffloadOptimizerTier:
    """Host f32 masters and optimizer state; device parameters in the compute
    dtype. ``kind`` is ``"adam"`` (AdamW with ``adam_w_mode``) or
    ``"adagrad"``; ``nvme_path`` (Adam only) puts the moments on disk.

    ``params_device``: the freshly built f32 parameters, by name; the tier
    copies them to its masters and the caller frees them.
    :meth:`initial_device_params` builds the compute-dtype parameters the
    tier pushes into from then on, in place."""

    def __init__(self, params_device: Dict[str, torch.Tensor], compute_dtype: torch.dtype,
                 kind: str = "adam", betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, nvme_path: Optional[str] = None,
                 aio_config: Optional[dict] = None):
        if _process_count() > 1:
            raise NotImplementedError(
                "ZeRO-Offload over several processes (each process's master shards, JAX's "
                "partitioned tier) is not ported yet: ROADMAP.md queue 1 item 11")
        if kind not in ("adam", "adagrad"):
            raise ValueError(f"offload optimizer kind {kind!r} not supported (adam, adagrad)")
        if nvme_path is not None and kind != "adam":
            raise ValueError("nvme offload supports adam/adamw only")
        self.names = list(params_device)
        leaves = list(params_device.values())
        self.device = leaves[0].device
        self._cuda = self.device.type == "cuda"
        self._shapes = [tuple(p.shape) for p in leaves]
        self.compute_dtype = compute_dtype
        # the gradients' dtype on the wire: bf16 keeps f32's exponent range; fp16's
        # would flush the small gradients loss scaling exists to keep, so fp16 ships f32
        self.transfer_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                               else torch.float32)
        self.kind = kind
        self.masters = [self._host(p.numel(), torch.float32) for p in leaves]
        with torch.no_grad():
            for dst, p in zip(self.masters, leaves):
                dst.copy_(p.detach().reshape(-1), non_blocking=self._cuda)
        self._sync()
        self._grads = [self._host(p.numel(), self.transfer_dtype) for p in leaves]
        self._stage = ([self._host(p.numel(), compute_dtype) for p in leaves]
                       if compute_dtype != torch.float32 else None)
        # the f32 copy of one 16-bit gradient at a time (DeepSpeedCPUAdam keeps its own)
        self._g32 = (torch.empty(max(p.numel() for p in leaves))
                     if self.transfer_dtype != torch.float32
                     and (kind == "adagrad" or nvme_path is not None) else None)
        self.device_params: List[torch.Tensor] = []
        self.step_count = 0
        self.nvme = None
        self.opt = None
        self.sq_sum = None
        if kind == "adam" and nvme_path is not None:
            self.nvme = _NVMeMomentStore(nvme_path, [m.numel() for m in self.masters],
                                         aio_config or {})
            self._adam_kwargs = dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                     adam_w_mode=adam_w_mode, bias_correction=bias_correction)
        elif kind == "adam":
            self.opt = DeepSpeedCPUAdam(self.masters, betas=betas, eps=eps,
                                        weight_decay=weight_decay, adamw_mode=adam_w_mode,
                                        bias_correction=bias_correction)
        else:
            self.eps, self.weight_decay = eps, weight_decay
            self.sq_sum = [self._host(m.numel(), torch.float32).zero_() for m in self.masters]
        self.last_step_s: Dict[str, float] = {}
        log_dist(f"ZeRO-Offload: {sum(m.numel() for m in self.masters):,} master params on "
                 f"the host ({kind}{', moments on nvme' if self.nvme else ''}), "
                 f"{self.host_bytes() / 2**30:.2f} GiB", ranks=[0])

    # ------------------------------------------------------------- buffers
    def _host(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, pin_memory=self._cuda)

    def _sync(self) -> None:
        """Wait for the copies on the current stream (pushes, the gradient
        copies): an event, not a device-wide synchronise."""
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    def host_bytes(self) -> int:
        """Bytes the tier holds in host memory: masters, moments or sums in
        RAM, the gradient and staging buffers, the NVMe scratch."""
        tensors = list(self.masters) + self._grads + (self._stage or [])
        tensors += [self._g32] if self._g32 is not None else []
        if self.opt is not None:
            tensors += self.opt.m + self.opt.v
            tensors += [self.opt._scratch] if self.opt._scratch is not None else []
        tensors += self.sq_sum or []
        tensors += self.nvme._scratch if self.nvme is not None else []
        return sum(t.numel() * t.element_size() for t in tensors)

    def named_masters(self) -> Dict[str, torch.Tensor]:
        """The f32 masters by parameter name, shaped (views of the tier's own)."""
        return {n: m.view(s) for n, m, s in zip(self.names, self.masters, self._shapes)}

    def _grad_f32(self, i: int) -> torch.Tensor:
        return as_f32(self._grads[i], self._g32)

    # ---------------------------------------------------------------- push
    @torch.no_grad()
    def _push_leaf(self, i: int) -> None:
        """Leaf ``i``'s master, cast to the compute dtype, into its device
        parameter without blocking (from pinned memory on CUDA)."""
        src = cast_master_to(self.masters[i], self._shapes[i], self.compute_dtype,
                             None if self._stage is None else self._stage[i])
        self.device_params[i].copy_(src, non_blocking=self._cuda)

    def push(self) -> None:
        """Every master to its device parameter (after a load or a reseed)."""
        self._sync()      # no earlier push still reads a staging buffer
        for i in range(len(self.masters)):
            self._push_leaf(i)

    def initial_device_params(self) -> Dict[str, torch.Tensor]:
        """The compute-dtype device parameters, by name, filled from the masters;
        later steps and loads push into these same tensors."""
        self.device_params = [torch.empty(s, dtype=self.compute_dtype, device=self.device)
                              for s in self._shapes]
        self.push()
        return dict(zip(self.names, self.device_params))

    # ---------------------------------------------------------------- step
    def step(self, grads_device: Sequence[torch.Tensor], lr: float,
             skip: bool = False) -> bool:
        """One host optimizer step from the device gradients (transfer dtype,
        in ``names`` order), each leaf pushed to its device parameter right
        after its update. ``skip`` (an fp16 overflow) leaves the masters, the
        state and the step count alone. Returns whether it stepped."""
        if skip:
            return False
        t0 = time.perf_counter()
        with torch.no_grad():
            for dst, g in zip(self._grads, grads_device):
                dst.copy_(g.reshape(-1), non_blocking=self._cuda)
        self._sync()
        t1 = time.perf_counter()
        lr = float(lr)
        if self.nvme is not None:
            self.step_count += 1
            self.nvme.adam_step_all(self.masters.__getitem__, self._grad_f32, lr,
                                    self.step_count,
                                    on_leaf_done=self._push_leaf, **self._adam_kwargs)
        elif self.kind == "adam":
            self.opt.step(self._grads, lr=lr, on_leaf_done=self._push_leaf)
            self.step_count = self.opt.step_count
        else:
            self.step_count += 1
            for i, (p, s) in enumerate(zip(self.masters, self.sq_sum)):
                adagrad_step(p, s, self._grad_f32(i), lr, self.eps, self.weight_decay)
                self._push_leaf(i)
        self.last_step_s = {"d2h_wait_s": t1 - t0, "host_update_s": time.perf_counter() - t1}
        return True

    @torch.no_grad()
    def reseed_from_device(self, params_device: Dict[str, torch.Tensor]) -> None:
        """Masters from the (compute-dtype) device parameters: a module-only
        load, or a tag written without the tier."""
        self._sync()
        for dst, p in zip(self.masters, params_device.values()):
            dst.copy_(p.detach().float().reshape(-1))

    # --------------------------------------------------------- checkpoints
    def has_checkpoint(self, path: str) -> bool:
        return os.path.isdir(path)

    def _light(self) -> dict:
        return {"masters": {f"leaf{i}": m.view(self._shapes[i])
                            for i, m in enumerate(self.masters)},
                "step": torch.tensor(self.step_count, dtype=torch.int64)}

    def save_to(self, checkpoint_engine, path: str) -> None:
        """The tier's state under ``path`` through the engine's checkpoint
        engine; the NVMe tier saves masters and step and copies its moment
        files to ``<path>_moments`` (never through host memory)."""
        self._sync()
        if self.nvme is not None:
            checkpoint_engine.save(self._light(), path)
            self.nvme.copy_files_to(path + "_moments")
            return
        checkpoint_engine.save(self.state_dict(), path)

    def read_checkpoint(self, checkpoint_engine, path: str) -> dict:
        """The tier's state at ``path`` read to the host and checked against
        the tier (names, shapes, dtypes; the NVMe files' sizes), before
        anything is installed: raises on any mismatch."""
        from ..engine import _check_like
        restored = checkpoint_engine.load(path)
        if self.nvme is not None:
            _check_like(self._light(), restored, path)
            restored["_moment_sizes"] = self.nvme.check_files(path + "_moments")
            restored["_moments_dir"] = path + "_moments"
            return restored
        _check_like(self.state_dict(), restored, path)
        for i, s in enumerate(self._shapes):
            if tuple(restored["shapes"][f"leaf{i}"].tolist()) != s:
                raise ValueError(f"checkpoint {path}: leaf{i} has shape "
                                 f"{restored['shapes'][f'leaf{i}'].tolist()}, the tier's {s}")
        return restored

    def install(self, restored: dict) -> None:
        """Write what :meth:`read_checkpoint` returned into the tier (the
        caller pushes the masters to the device)."""
        if self.nvme is not None:
            self._sync()
            for m, src in zip(self.masters, restored["masters"].values()):
                m.copy_(src.reshape(-1))
            self.step_count = int(restored["step"])
            self.nvme.copy_files_from(restored["_moments_dir"], restored["_moment_sizes"])
            return
        self.load_state_dict(restored)

    def load_from(self, checkpoint_engine, path: str) -> None:
        self.install(self.read_checkpoint(checkpoint_engine, path))

    def state_dict(self) -> dict:
        """JAX's layout: ``masters``, ``shapes``, then ``m``/``v`` or
        ``sq_sum``, and ``step``, each keyed ``leaf{i}``. Tensors are the
        tier's own (the checkpoint engine copies them)."""
        def keyed(ts):
            return {f"leaf{i}": t.view(self._shapes[i]) for i, t in enumerate(ts)}

        sd = {"masters": keyed(self.masters),
              "shapes": {f"leaf{i}": torch.tensor(s, dtype=torch.int64)
                         for i, s in enumerate(self._shapes)}}
        if self.nvme is not None:
            sd["m"], sd["v"] = map(keyed, self.nvme.read_moments())
        elif self.kind == "adam":
            sd["m"], sd["v"] = keyed(self.opt.m), keyed(self.opt.v)
        else:
            sd["sq_sum"] = keyed(self.sq_sum)
        sd["step"] = torch.tensor(self.step_count, dtype=torch.int64)
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self._sync()
        n = len(self.masters)
        for i, m in enumerate(self.masters):
            m.copy_(sd["masters"][f"leaf{i}"].reshape(-1))
        self.step_count = int(sd["step"])
        if self.nvme is not None:
            self.nvme.write_moments([sd["m"][f"leaf{i}"] for i in range(n)],
                                    [sd["v"][f"leaf{i}"] for i in range(n)])
        elif self.kind == "adam":
            self.opt.load_state_dict({"step": self.step_count,
                                      "m": [sd["m"][f"leaf{i}"] for i in range(n)],
                                      "v": [sd["v"][f"leaf{i}"] for i in range(n)]})
        else:
            for i, s in enumerate(self.sq_sum):
                s.copy_(sd["sq_sum"][f"leaf{i}"].reshape(-1))
