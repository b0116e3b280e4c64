"""ZeRO-3 parameter offload: the parameters live on the host and stream to the
device one model segment at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/param_offload.py``, for one
process. The model is cut into :class:`~...models.base.Segment` slices
(``models/causal_lm.py:causal_lm_segments``); the device holds no parameter
tree and no optimizer state. The host holds the f32 masters and the f32
gradient accumulators as flat CPU tensors in the global leaf order (the
segments' ``init_keys`` in order, each key's tensors in its dict's order), in
pageable memory; only the staging and landing buffers of the copies are
pinned. A step (:meth:`ParamOffloadCoordinator.train_step`):

- **forward**: segments 0 … G−2 run under ``no_grad``, keeping only the
  boundary carries, while the next segment's parameters are already on their
  way (:class:`_StreamCache`, a window of two segments). Each key is cast on
  the host to the compute dtype (``cast_master_to``: the C++ f32 → bf16 for
  bf16) into a pinned staging buffer and copied to the card on a copy stream;
  the compute stream waits on that copy's event before it reads the tensors.
- **backward**: segments G−1 … 0, each recomputing its forward under
  ``enable_grad`` on its detached input carry and differentiating it with
  ``torch.autograd.grad`` (the last segment's output is the loss times the
  loss scale). Each segment's parameter gradients go to pinned landing buffers
  on a second copy stream as soon as its backward is queued; the host adds
  them to the f32 accumulators after the next segment's backward is queued,
  waiting on the copy's event, so the copy and the add overlap the device's
  next segment. The gradients cross in the compute dtype and widen on the
  host (JAX widens them on the device: the same values, half the bytes).
  Segment 0 stays on the device between micro-batches.
- **update**: unscale by ``scale * n_micro`` and clip in one multiply, from
  the global norm of the accumulators' sums of squares; under fp16 a
  non-finite norm skips the step (``_norm_overflow``, ``_clip_coef``,
  ``_finish_update``: one definition for both tiers); then the C++ Adam
  (``ops/adam/cpu_adam.py``) or Adagrad updates the masters in place. Adam's
  moments live on disk with ``offload_optimizer: nvme``
  (``offload.py:_NVMeMomentStore``).

With ``offload_param: nvme`` (:class:`_NVMeParamTier`) the masters and the
accumulators live in files too, one O_DIRECT file a leaf each through the
async I/O handle, and so do the moments: host memory is the tier's scratch,
a few times the largest leaf, whatever the model's size. The update then
streams each leaf's master, gradient and moments in while the previous leaf
updates. NVMe parameters take Adam or AdamW only, as in JAX.

Several processes (JAX's ``_partitioned`` coordinator, each process holding
its masters' shards along the gradient layout) wait for data parallelism,
ROADMAP.md queue 1 item 11.
"""

import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ...models.base import Segment
from ...ops.adam.cpu_adam import DeepSpeedCPUAdam, adagrad_step
from ...ops.aio.aio_handle import aligned_array, padded_len
from ...utils.logging import log_dist
from .. import rng as rng_stream
from ..fp16.loss_scaler import DynamicLossScaler, LossScaleState
from .offload import _NVMeMomentStore, _process_count, cast_master_to, make_swap_handle


class _StreamCache:
    """The window of device-resident segment parameters (JAX ``:62-93``).
    ``prefetch`` pushes a segment without waiting for its copies; ``get``
    returns it (pushing first on a miss); ``evict`` drops the reference, and
    the allocator reuses the memory once the compute stream is past the
    segment's last use. ``peak_live_bytes``: the most compute-dtype bytes held
    at once."""

    def __init__(self, push_fn: Callable[[int], Any]):
        self._push = push_fn
        self._live: Dict[int, Any] = {}
        self._live_bytes: Dict[int, int] = {}
        self.peak_live_bytes = 0

    def prefetch(self, si: int) -> None:
        if si not in self._live:
            pushed = self._push(si)
            self._live[si] = pushed
            self._live_bytes[si] = pushed.nbytes
            self.peak_live_bytes = max(self.peak_live_bytes, sum(self._live_bytes.values()))

    def get(self, si: int):
        self.prefetch(si)
        return self._live[si]

    def evict(self, si: int) -> None:
        self._live.pop(si, None)
        self._live_bytes.pop(si, None)

    def clear(self) -> None:
        self._live.clear()
        self._live_bytes.clear()


class _Pushed:
    """One segment's parameters on the device: ``params`` (a tuple of dicts
    in ``param_keys`` order, leaves that require grad), its compute-dtype
    ``nbytes``, and the copy's ``event`` that the compute stream waits on
    before its first use (None on the CPU)."""

    def __init__(self, params, nbytes: int, flats: List[torch.Tensor], event):
        self.params = params
        self.nbytes = nbytes
        self.flats = flats
        self.event = event


class _PinnedRing:
    """``count`` pinned host buffers of ``numel`` elements handed out in turn;
    a buffer goes out again only after the event of its last copy fired, so a
    cast never overwrites bytes a copy still reads."""

    def __init__(self, count: int, numel: int, dtype: torch.dtype):
        self.bufs = [torch.empty(numel, dtype=dtype, pin_memory=True) for _ in range(count)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * count
        self._next = 0

    def take(self) -> int:
        k = self._next
        self._next = (k + 1) % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return k

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs)


class _NVMeParamTier:
    """f32 masters and gradient accumulators on disk (JAX ``:96-231``): one
    file a leaf each (``masters_leaf{i}.bin``, ``grads_leaf{i}.bin``) under
    ``path``, its length padded to the O_DIRECT granularity, through the async
    I/O handle. Host memory: two master and two gradient buffers for the
    update's double buffering and one push buffer, each the padded largest
    leaf (``scratch_bytes``). ``leaf_sq[i]``: the current accumulator's sum
    of squares, kept at every add so the update needs no pass for the norm."""

    def __init__(self, path: str, sizes: Sequence[int], aio_config: dict):
        self.path = path
        self.sizes = [int(s) for s in sizes]
        n = len(self.sizes)
        self.handle = make_swap_handle(path, aio_config, "offload_param.device=nvme")
        self._mfiles = [os.path.join(path, f"masters_leaf{i}.bin") for i in range(n)]
        self._gfiles = [os.path.join(path, f"grads_leaf{i}.bin") for i in range(n)]
        cap = self._padded(max(self.sizes))
        self._mbuf = [aligned_array(cap * 4, torch.float32) for _ in range(2)]
        self._gbuf = [aligned_array(cap * 4, torch.float32) for _ in range(2)]
        self._pushbuf = aligned_array(cap * 4, torch.float32)
        self.scratch_bytes = 5 * cap * 4
        self.grad_dirty = [False] * n
        self.leaf_sq = [0.0] * n

    def _padded(self, s: int) -> int:
        return padded_len(s, 4)

    # ------------------------------------------------------------- masters
    def write_master(self, i: int, flat: torch.Tensor) -> None:
        """A synchronous master write (initialisation, loads)."""
        s, buf = self.sizes[i], self._pushbuf
        buf[:s].copy_(flat.reshape(-1))
        buf[s:self._padded(s)].zero_()
        self.handle.sync_pwrite(buf[:self._padded(s)], self._mfiles[i])

    def read_master(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s master, read synchronously into the push buffer (valid
        until the next read on this tier)."""
        s = self.sizes[i]
        self.handle.sync_pread(self._pushbuf[:self._padded(s)], self._mfiles[i])
        return self._pushbuf[:s]

    def read_masters_pipelined(self, indices):
        """Each leaf's f32 master in turn, leaf j + 1 read while the consumer
        casts leaf j (each view is valid until the next iteration)."""
        idx = list(indices)
        if not idx:
            return
        self.handle.async_pread(self._mbuf[0][:self._padded(self.sizes[idx[0]])],
                                self._mfiles[idx[0]])
        self.handle.wait()
        for j, i in enumerate(idx):
            if j + 1 < len(idx):
                nxt = idx[j + 1]
                self.handle.async_pread(self._mbuf[(j + 1) % 2][:self._padded(self.sizes[nxt])],
                                        self._mfiles[nxt])
            yield self._mbuf[j % 2][:self.sizes[i]]
            self.handle.wait()

    # --------------------------------------------------------------- grads
    def reset_grads(self) -> None:
        self.grad_dirty = [False] * len(self.sizes)
        self.leaf_sq = [0.0] * len(self.sizes)

    def accumulate_leaf(self, i: int, contrib: torch.Tensor) -> None:
        """accumulator[i] += contrib, through the scratch (read, add, write)."""
        s, p, buf = self.sizes[i], self._padded(self.sizes[i]), self._gbuf[0]
        acc = buf[:s]
        if self.grad_dirty[i]:
            self.handle.sync_pread(buf[:p], self._gfiles[i])
            acc.add_(contrib.reshape(-1))
        else:
            acc.copy_(contrib.reshape(-1))
            buf[s:p].zero_()
        self.leaf_sq[i] = float(torch.dot(acc, acc))
        self.handle.sync_pwrite(buf[:p], self._gfiles[i])
        self.grad_dirty[i] = True

    # -------------------------------------------------------------- update
    def fetch_mg(self, i: int, slot: int) -> None:
        """Leaf ``i``'s master and accumulator into buffer pair ``slot``."""
        p = self._padded(self.sizes[i])
        self.handle.async_pread(self._mbuf[slot][:p], self._mfiles[i])
        self.handle.async_pread(self._gbuf[slot][:p], self._gfiles[i])

    def take(self, i: int):
        """The update's leaf ``i``: wait for its reads (and leaf ``i - 1``'s
        master write), start leaf ``i + 1``'s, return (master, gradient)."""
        self.handle.wait()
        if i + 1 < len(self.sizes):
            self.fetch_mg(i + 1, (i + 1) % 2)
        s = self.sizes[i]
        return self._mbuf[i % 2][:s], self._gbuf[i % 2][:s]

    def write_master_async(self, i: int) -> None:
        self.handle.async_pwrite(self._mbuf[i % 2][:self._padded(self.sizes[i])],
                                 self._mfiles[i])

    # ---------------------------------------------------------- checkpoints
    def copy_masters_to(self, dest_dir: str) -> None:
        os.makedirs(dest_dir, exist_ok=True)
        self.handle.wait()
        for f in self._mfiles:
            shutil.copy2(f, os.path.join(dest_dir, os.path.basename(f)))

    def check_masters(self, src_dir: str) -> None:
        """Raise before anything is installed unless ``src_dir`` holds every
        master file at its padded length."""
        for i, f in enumerate(self._mfiles):
            src = os.path.join(src_dir, os.path.basename(f))
            want = self._padded(self.sizes[i]) * 4
            if not os.path.isfile(src):
                raise RuntimeError(f"missing master file {src} in checkpoint: the checkpoint "
                                   "is incomplete; restore from the previous 'latest' tag")
            if os.path.getsize(src) != want:
                raise RuntimeError(f"corrupt master file {src}: {os.path.getsize(src)} bytes, "
                                   f"expected {want}; restore from the previous 'latest' tag")

    def copy_masters_from(self, src_dir: str) -> None:
        self.handle.wait()
        for f in self._mfiles:
            shutil.copy2(os.path.join(src_dir, os.path.basename(f)), f)


class ParamOffloadCoordinator:
    """Host f32 masters for the whole model and the streamed step (JAX
    ``ParamOffloadCoordinator``, one process). Owns the optimizer (Adam,
    AdamW or Adagrad on the host) and the loss scaler's state (on the CPU);
    the engine hands it ``train_batch``, ``eval_batch`` and checkpoints when
    ``zero_optimization.offload_param`` is on.

    ``seed`` is the engine's stream root: segment ``si`` initialises from
    ``fold_in(seed, si)`` on ``device`` (one segment at a time), and its
    masters go to the host (or the disk) before the next one is made."""

    def __init__(self, segments: List[Segment], seed: int, compute_dtype: torch.dtype,
                 device, kind: str = "adam", betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, gradient_clipping: float = 0.0,
                 fp16_enabled: bool = False,
                 loss_scaler: Optional[DynamicLossScaler] = None,
                 scaler_state: Optional[LossScaleState] = None,
                 nvme_path: Optional[str] = None, nvme_param_path: Optional[str] = None,
                 aio_config: Optional[dict] = None):
        if _process_count() > 1:
            raise NotImplementedError(
                "ZeRO-3 parameter offload over several processes (each process's master "
                "shards, JAX's partitioned coordinator) is not ported yet: ROADMAP.md queue 1 "
                "item 11")
        if not (segments and segments[0].kind == "first" and segments[-1].kind == "last"
                and all(s.kind == "mid" for s in segments[1:-1])):
            raise ValueError("segments must run first -> mid* -> last")
        if kind not in ("adam", "adagrad"):
            raise ValueError(f"offload_param optimizer kind {kind!r} (adam, adagrad)")
        self.nvme_params = nvme_param_path is not None
        if self.nvme_params:
            if kind != "adam":
                raise ValueError(f"offload_param.device='nvme' supports adam/adamw only "
                                 f"(got {kind!r})")
            # masters on disk imply the moments on disk: if 4 B a parameter do
            # not fit in host memory, Adam's 8 B do not either
            nvme_path = nvme_path or os.path.join(nvme_param_path, "moments")
        self.segments = segments
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.kind = kind
        self.gradient_clipping = gradient_clipping
        self.fp16_enabled = fp16_enabled
        self.loss_scaler = loss_scaler
        self.scaler_state = (None if scaler_state is None else
                             LossScaleState(*(t.detach().to("cpu") for t in scaler_state)))
        self._skipped_steps = 0
        self._new_timings()
        self.last_step_s: Dict[str, float] = {}
        self.last_step_bytes: Dict[str, int] = {}

        # ---- the leaf order, from each segment's shapes (no draw) ----------
        self.key_names: Dict[str, List[str]] = {}
        self.key_shapes: Dict[str, List[torch.Size]] = {}
        self._key_order: List[str] = []
        for seg in segments:
            abstract = seg.init_fn(seed, "meta")
            if len(abstract) != len(seg.init_keys):
                raise ValueError(f"segment {seg.name}: init_fn must return one dict a "
                                 "init key")
            for key, sub in zip(seg.init_keys, abstract):
                if key in self.key_names:
                    raise ValueError(f"segment {seg.name}: key {key!r} initialised twice")
                self.key_names[key] = list(sub)
                self.key_shapes[key] = [t.shape for t in sub.values()]
                self._key_order.append(key)
        missing = [k for s in segments for k in s.param_keys if k not in self.key_names]
        if missing:
            raise ValueError(f"segment keys {missing} are initialised by no segment")
        self._leaf_index: Dict[str, List[int]] = {}
        sizes: List[int] = []
        for key in self._key_order:
            self._leaf_index[key] = list(range(len(sizes), len(sizes) + len(self.key_shapes[key])))
            sizes += [int(torch.Size(s).numel()) for s in self.key_shapes[key]]
        self.leaf_sizes = sizes
        self.total_params = sum(sizes)
        self.param_tier = (_NVMeParamTier(nvme_param_path, sizes, aio_config or {})
                           if self.nvme_params else None)

        # ---- initialisation, one segment at a time -------------------------
        self.masters: Optional[List[torch.Tensor]] = None if self.nvme_params else \
            [torch.empty(s, dtype=torch.float32) for s in sizes]
        for si, seg in enumerate(segments):
            if not seg.init_keys:
                continue
            made = seg.init_fn(rng_stream.fold_in(seed, si), self.device)
            for key, sub in zip(seg.init_keys, made):
                for i, t in zip(self._leaf_index[key], sub.values()):
                    flat = t.detach().reshape(-1).to("cpu", torch.float32)
                    if self.nvme_params:
                        self.param_tier.write_master(i, flat)
                    else:
                        self.masters[i].copy_(flat)
            del made
        self._accum: Optional[List[torch.Tensor]] = None if self.nvme_params else \
            [torch.zeros(s, dtype=torch.float32) for s in sizes]

        # ---- the optimizer -------------------------------------------------
        self.opt = None
        self.nvme = None
        self.sq_sum = None
        self.step_count = 0
        self._adam_kwargs = dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                 adam_w_mode=adam_w_mode, bias_correction=bias_correction)
        if kind == "adam" and nvme_path is not None:
            self.nvme = _NVMeMomentStore(nvme_path, sizes, aio_config or {})
        elif kind == "adam":
            self.opt = DeepSpeedCPUAdam(self.masters, betas=betas, eps=eps,
                                        weight_decay=weight_decay, adamw_mode=adam_w_mode,
                                        bias_correction=bias_correction)
        else:
            self.eps, self.weight_decay = eps, weight_decay
            self.sq_sum = [torch.zeros(s, dtype=torch.float32) for s in sizes]

        # ---- copies: pinned staging and landing rings, one stream each way --
        seg_elems = [sum(self.leaf_sizes[i] for k in s.param_keys for i in self._leaf_index[k])
                     for s in segments]
        self._stage = self._land = None
        if self._cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
            self._stage = _PinnedRing(3, max(seg_elems), compute_dtype)
            self._land = _PinnedRing(2, max(seg_elems), compute_dtype)
        self.cache = _StreamCache(self._push_segment)
        log_dist(f"ZeRO-3 param offload: {self.total_params:,} params on "
                 f"{'NVMe' if self.nvme_params else 'the host'} across {len(segments)} "
                 f"segments ({kind}{', moments on nvme' if self.nvme is not None else ''}), "
                 f"{self.host_bytes() / 2**30:.2f} GiB of host memory", ranks=[0])

    # ------------------------------------------------------------- accounting
    def host_bytes(self) -> int:
        """Bytes the coordinator holds in host memory: masters, accumulators,
        moments or sums in RAM, the pinned rings, the NVMe scratch."""
        tensors = list(self.masters or []) + list(self._accum or []) + list(self.sq_sum or [])
        if self.opt is not None:
            tensors += self.opt.m + self.opt.v
        n = sum(t.numel() * t.element_size() for t in tensors)
        n += sum(ring.nbytes() for ring in (self._stage, self._land) if ring is not None)
        if self.param_tier is not None:
            n += self.param_tier.scratch_bytes
        if self.nvme is not None:
            n += sum(t.numel() * t.element_size() for t in self.nvme._scratch)
        return n

    def _new_timings(self) -> None:
        """Zero the host seconds (push: casts and copies queued; accumulate:
        waiting for and adding the gradients; update: the optimizer) and the
        bytes copied each way that a step or an eval reports."""
        self._t = {"push_s": 0.0, "accumulate_s": 0.0, "update_s": 0.0}
        self._bytes = {"pushed": 0, "pulled": 0}

    def _cur_scale(self) -> float:
        return 1.0 if self.scaler_state is None else float(self.scaler_state.cur_scale)

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    # ------------------------------------------------------------------- push
    def _key_masters(self, key: str):
        """``key``'s f32 masters, flat, in leaf order (from disk in turn under
        NVMe parameters: each view is valid until the next)."""
        if self.nvme_params:
            return self.param_tier.read_masters_pipelined(self._leaf_index[key])
        return (self.masters[i] for i in self._leaf_index[key])

    @torch.no_grad()
    def _push_segment(self, si: int) -> _Pushed:
        """Segment ``si``'s parameters in the compute dtype on the device: each
        key cast on the host into a pinned staging buffer, then one copy a key
        on the copy stream into memory allocated there; the event after the
        last copy is the compute stream's to wait on."""
        t0 = time.perf_counter()
        seg, dtype = self.segments[si], self.compute_dtype
        params, flats, nbytes = [], [], 0
        if self._cuda:
            k = self._stage.take()
            stage, off = self._stage.bufs[k], 0
        for key in seg.param_keys:
            n_key = sum(self.leaf_sizes[i] for i in self._leaf_index[key])
            if self._cuda:
                host = stage[off:off + n_key]
                off += n_key
            else:
                host = torch.empty(n_key, dtype=dtype)
            pos = 0
            for i, master in zip(self._leaf_index[key], self._key_masters(key)):
                s = self.leaf_sizes[i]
                if dtype == torch.float32:
                    host[pos:pos + s].copy_(master)
                else:
                    cast_master_to(master, (s,), dtype, host[pos:pos + s])
                pos += s
            if self._cuda:
                with torch.cuda.stream(self._h2d):
                    flat = torch.empty(n_key, dtype=dtype, device=self.device)
                    flat.copy_(host, non_blocking=True)
            else:
                flat = host
            flats.append(flat)
            nbytes += n_key * flat.element_size()
            views, pos = {}, 0
            for name, shape in zip(self.key_names[key], self.key_shapes[key]):
                s = int(torch.Size(shape).numel())
                views[name] = flat[pos:pos + s].view(shape).detach().requires_grad_()
                pos += s
            params.append(views)
        event = None
        if self._cuda:
            event = self._h2d.record_event()
            self._stage.events[k] = event
        self._t["push_s"] += time.perf_counter() - t0
        self._bytes["pushed"] += nbytes
        return _Pushed(tuple(params), nbytes, flats, event)

    def _params(self, si: int):
        """Segment ``si``'s device parameters, ready for the compute stream."""
        pushed = self.cache.get(si)
        if pushed.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pushed.event)
            for flat in pushed.flats:
                flat.record_stream(stream)
            pushed.event = None
        return pushed.params

    # --------------------------------------------------------------- gradients
    def _send_grads(self, si: int, grads: List[torch.Tensor]):
        """Segment ``si``'s parameter gradients on their way to the host: on
        the CUDA side into a pinned landing buffer on the second copy stream,
        behind the compute queued so far. Returns what :meth:`_accumulate`
        takes."""
        if not self._cuda:
            return si, [g.reshape(-1) for g in grads], None
        compute = torch.cuda.current_stream(self.device)
        self._d2h.wait_stream(compute)
        k = self._land.take()
        land, off, views = self._land.bufs[k], 0, []
        with torch.cuda.stream(self._d2h):
            for g in grads:
                n = g.numel()
                land[off:off + n].copy_(g.reshape(-1), non_blocking=True)
                g.record_stream(self._d2h)
                views.append(land[off:off + n])
                off += n
            event = self._d2h.record_event()
        self._land.events[k] = event
        self._bytes["pulled"] += off * land.element_size()
        return si, views, event

    def _accumulate(self, pending) -> None:
        """Add one segment's gradients (in ``param_keys`` order, a tied key's
        to the same accumulator as its first use) to the f32 accumulators,
        once their copy has landed."""
        si, views, event = pending
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        idx = [i for key in self.segments[si].param_keys for i in self._leaf_index[key]]
        for i, g in zip(idx, views):
            if self.nvme_params:
                self.param_tier.accumulate_leaf(i, g)
            else:
                self._accum[i].add_(g)
        self._t["accumulate_s"] += time.perf_counter() - t0

    def _zero_accum(self) -> None:
        if self.nvme_params:
            self.param_tier.reset_grads()
        else:
            for g in self._accum:
                g.zero_()

    # -------------------------------------------------------------------- step
    def _forward(self, g: int, params, x, batch, key):
        seg = self.segments[g]
        if seg.kind == "first":
            return seg.apply_fn(params, batch, key)
        return seg.apply_fn(params, x, batch, key)

    def _backward(self, g: int, params, x, batch, key, gout, scale: float):
        """Segment ``g``'s forward recomputed under ``enable_grad`` on its
        detached input and differentiated: (loss or None, parameter gradients
        in leaf order, gradient of the input carry or None)."""
        seg = self.segments[g]
        leaves = [t for p in params for t in p.values()]
        loss = None
        with torch.enable_grad():
            if seg.kind == "first":
                out = seg.apply_fn(params, batch, key)
                wrt = leaves
            else:
                x = x.detach().requires_grad_()
                out = seg.apply_fn(params, x, batch, key)
                wrt = leaves + [x]
            if seg.kind == "last":
                loss = out.detach()
                out, gout = out * scale, None
            grads = list(torch.autograd.grad(out, wrt, gout, allow_unused=True))
        gx = grads.pop() if seg.kind != "first" else None
        grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads)]
        return loss, grads, gx

    def train_step(self, microbatches: List[Dict[str, torch.Tensor]], lr: float,
                   key: int) -> Dict[str, Any]:
        """One optimizer step over ``len(microbatches)`` streamed forward and
        backward passes (JAX ``:699-765``); segment ``g`` of micro-batch ``m``
        gets the key ``fold_in(fold_in(key, m), g)``. Returns the metrics: the
        mean loss (a 0-d device tensor), the gradient norm, overflow and the
        loss scale used."""
        self._new_timings()
        G, cache = len(self.segments), self.cache
        scale = self._cur_scale()
        self._zero_accum()
        losses = []
        for mi, batch in enumerate(microbatches):
            mb_key = rng_stream.fold_in(key, mi)
            xs: List[Optional[torch.Tensor]] = [None] * G
            x = None
            with torch.no_grad():                 # forward: segments 0 .. G-2
                for g in range(G - 1):
                    cache.prefetch(g + 1)
                    xs[g] = x
                    x = self._forward(g, self._params(g), x, batch,
                                      rng_stream.fold_in(mb_key, g))
                    if g < G - 2:
                        cache.evict(g)
            xs[G - 1] = x
            gout, pending = None, None
            for g in range(G - 1, -1, -1):        # backward: G-1 .. 0
                if g > 0:
                    cache.prefetch(g - 1)
                loss, grads, gout = self._backward(g, self._params(g), xs[g], batch,
                                                   rng_stream.fold_in(mb_key, g), gout, scale)
                if loss is not None:
                    losses.append(loss)
                xs[g] = None
                if g > 0:
                    cache.evict(g)    # segment 0 stays for the next micro-batch's forward
                sent = self._send_grads(g, grads)
                del grads
                if pending is not None:
                    self._accumulate(pending)     # behind segment g's queued backward
                pending = sent
            self._accumulate(pending)
        cache.clear()
        metrics = self._host_update(lr, len(microbatches), scale)
        metrics["loss"] = torch.stack(losses).mean()
        self.last_step_s = dict(self._t)
        self.last_step_bytes = dict(self._bytes)
        return metrics

    # ------------------------------------------------------------------ update
    # one definition of the overflow, clip and scaler logic for the RAM and NVMe
    # update paths, so they cannot part (JAX :787-804)
    def _norm_overflow(self, total_sq: float):
        norm = total_sq ** 0.5
        return norm, self.fp16_enabled and not (norm < float("inf"))

    def _clip_coef(self, norm: float) -> float:
        clip = self.gradient_clipping
        if clip and clip > 0 and norm < float("inf") and norm > clip:
            return clip / (norm + 1e-6)
        return 1.0

    def _finish_update(self, overflow: bool, norm: float, scale: float) -> Dict[str, Any]:
        if overflow:
            self._skipped_steps += 1
        if self.loss_scaler is not None and self.scaler_state is not None:
            self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                        torch.tensor(overflow))
        return {"grad_norm": norm, "overflow": overflow, "loss_scale": scale}

    def _host_update(self, lr: float, n_micro: int, scale: float) -> Dict[str, Any]:
        """Unscale and clip by one multiply, then the host optimizer, unless an
        fp16 overflow skips the step (JAX ``:806-877``). The norm comes from
        each accumulator's sum of squares (kept at every add under NVMe
        parameters), the same sums in both tiers."""
        t0 = time.perf_counter()
        inv = 1.0 / (scale * n_micro)
        if self.nvme_params:
            sq = self.param_tier.leaf_sq
        else:
            sq = [float(torch.dot(g, g)) for g in self._accum]
        norm, overflow = self._norm_overflow(sum(sq) * inv * inv)
        coef = inv * self._clip_coef(norm)
        if not overflow:
            lr = float(lr)
            if self.nvme_params:
                tier = self.param_tier
                taken = {}

                def param(i):
                    taken[i] = tier.take(i)
                    return taken[i][0]

                def grad(i):
                    return taken.pop(i)[1].mul_(coef)

                tier.fetch_mg(0, 0)
                self.step_count += 1
                self.nvme.adam_step_all(param, grad, lr, self.step_count,
                                        on_leaf_done=tier.write_master_async,
                                        **self._adam_kwargs)
                tier.handle.wait()
            else:
                for g in self._accum:
                    g.mul_(coef)
                if self.nvme is not None:
                    self.step_count += 1
                    self.nvme.adam_step_all(self.masters.__getitem__, self._accum.__getitem__,
                                            lr, self.step_count, **self._adam_kwargs)
                elif self.opt is not None:
                    self.opt.step(self._accum, lr=lr)
                    self.step_count = self.opt.step_count
                else:
                    self.step_count += 1
                    for p, s, g in zip(self.masters, self.sq_sum, self._accum):
                        adagrad_step(p, s, g, lr, self.eps, self.weight_decay)
        self._t["update_s"] += time.perf_counter() - t0
        return self._finish_update(overflow, norm, scale)

    # -------------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, torch.Tensor], key: int) -> torch.Tensor:
        """The loss of ``batch`` through every segment's forward, streamed as
        in training; segment ``g`` gets ``fold_in(key, g)``."""
        self._new_timings()
        G, cache, x = len(self.segments), self.cache, None
        for g in range(G):
            if g + 1 < G:
                cache.prefetch(g + 1)
            x = self._forward(g, self._params(g), x, batch, rng_stream.fold_in(key, g))
            cache.evict(g)
        cache.clear()
        return x

    # ------------------------------------------------------------- the masters
    def _master_flat(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s f32 master, flat (a copy under NVMe parameters)."""
        if self.nvme_params:
            return self.param_tier.read_master(i).clone()
        return self.masters[i]

    def named_masters(self) -> Dict[str, torch.Tensor]:
        """Every f32 master by parameter name, shaped: views of the tier's own
        in RAM, copies read from disk under NVMe parameters."""
        out = {}
        for key in self._key_order:
            for i, name, shape in zip(self._leaf_index[key], self.key_names[key],
                                      self.key_shapes[key]):
                out[name] = self._master_flat(i).view(shape)
        return out

    def full_params_host(self) -> Dict[str, torch.Tensor]:
        """The whole f32 parameter dict on the host, by name (copies)."""
        return {n: t.clone() for n, t in self.named_masters().items()}

    @torch.no_grad()
    def load_full_params(self, params: Dict[str, Any]) -> None:
        """Masters from a parameter dict by name (the resident model's names
        and shapes, any float dtype, any device); the optimizer state is left
        as it is."""
        want = [n for k in self._key_order for n in self.key_names[k]]
        if sorted(params) != sorted(want):
            raise ValueError(f"load_full_params: names differ from the model's: missing "
                             f"{sorted(set(want) - set(params))[:8]}, unexpected "
                             f"{sorted(set(params) - set(want))[:8]}")
        for key in self._key_order:
            for i, name, shape in zip(self._leaf_index[key], self.key_names[key],
                                      self.key_shapes[key]):
                src = torch.as_tensor(params[name])
                if tuple(src.shape) != tuple(shape):
                    raise ValueError(f"load_full_params: {name} is {tuple(src.shape)}, the "
                                     f"model's {tuple(shape)}")
                flat = src.detach().to("cpu", torch.float32).reshape(-1)
                if self.nvme_params:
                    self.param_tier.write_master(i, flat)
                else:
                    self.masters[i].copy_(flat)

    # ------------------------------------------------------------- checkpoints
    def _leaf_shapes(self) -> List[torch.Size]:
        return [s for k in self._key_order for s in self.key_shapes[k]]

    def _keyed(self, tensors) -> Dict[str, torch.Tensor]:
        return {f"leaf{i}": t.view(s) for i, (t, s) in enumerate(zip(tensors,
                                                                       self._leaf_shapes()))}

    def _light(self) -> dict:
        """Masters (in RAM), shapes, step and loss scaler: everything but the
        moments and the on-disk masters, which are copied as files."""
        sd = {"shapes": {f"leaf{i}": torch.tensor(list(s), dtype=torch.int64)
                         for i, s in enumerate(self._leaf_shapes())},
              "step": torch.tensor(self.step_count, dtype=torch.int64)}
        if not self.nvme_params:
            sd["masters"] = self._keyed(self.masters)
        if self.scaler_state is not None:
            st = self.scaler_state
            sd["scaler"] = torch.tensor([float(st.cur_scale), float(st.cur_hysteresis),
                                         float(st.last_overflow_iter), float(st.iteration)],
                                        dtype=torch.float64)
        return sd

    def state_dict(self) -> dict:
        """The whole state in host memory (``masters``, ``m``/``v`` or
        ``sq_sum``, each keyed ``leaf{i}``; ``shapes``, ``step``, ``scaler``):
        tests, exports and RAM-mode checkpoints. Under NVMe it reads the files;
        checkpoints copy them instead."""
        sd = self._light()
        if self.nvme_params:
            sd["masters"] = self._keyed([self._master_flat(i)
                                         for i in range(len(self.leaf_sizes))])
        if self.nvme is not None:
            sd["m"], sd["v"] = map(self._keyed, self.nvme.read_moments())
        elif self.opt is not None:
            sd["m"], sd["v"] = self._keyed(self.opt.m), self._keyed(self.opt.v)
        else:
            sd["sq_sum"] = self._keyed(self.sq_sum)
        return sd

    def save_to(self, checkpoint_engine, path: str) -> None:
        """The state under ``path``; with moments (and masters) on disk their
        files are copied to ``<path>_moments`` (``<path>_masters``), never
        through host memory (JAX ``:1035-1100``)."""
        if self.nvme is None:
            checkpoint_engine.save(self.state_dict(), path)
            return
        checkpoint_engine.save(self._light(), path)
        self.nvme.copy_files_to(path + "_moments")
        if self.nvme_params:
            self.param_tier.copy_masters_to(path + "_masters")

    def _template(self, optimizer: bool, in_memory: bool) -> dict:
        """What a state read back must hold (shapes and dtypes, on ``meta``):
        a tag's (``in_memory`` False: the on-disk masters and moments are
        files beside it) or a whole :meth:`state_dict`'s."""
        def like(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        leaves = {f"leaf{i}": like(s) for i, s in enumerate(self._leaf_shapes())}
        sd = {"shapes": {k: like((len(v.shape),), torch.int64) for k, v in leaves.items()},
              "step": like((), torch.int64)}
        if self.scaler_state is not None:
            sd["scaler"] = like((4,), torch.float64)
        if in_memory or not self.nvme_params:
            sd["masters"] = leaves
        if optimizer and (in_memory or self.nvme is None):
            if self.sq_sum is not None:
                sd["sq_sum"] = leaves
            else:
                sd["m"], sd["v"] = leaves, leaves
        return sd

    def _check(self, restored: dict, template: dict, where: str) -> None:
        """``restored`` holds ``template``'s entries with the model's shapes,
        or this raises naming what differs."""
        from ..engine import _check_like
        _check_like(template, {k: restored.get(k) for k in template}, where)
        for i, s in enumerate(self._leaf_shapes()):
            if restored["shapes"][f"leaf{i}"].tolist() != list(s):
                raise ValueError(f"checkpoint {where}: leaf{i} has shape "
                                 f"{restored['shapes'][f'leaf{i}'].tolist()}, the model's "
                                 f"{list(s)}")

    @torch.no_grad()
    def _install(self, restored: dict, optimizer: bool,
                 moments: Optional[Callable[[], None]] = None) -> None:
        """Write a checked state in: the masters it holds, and with
        ``optimizer`` the step, the moments (``moments()`` copies them from
        files when the state has none) or sums, and the loss scaler."""
        if "masters" in restored:
            for i in range(len(self.leaf_sizes)):
                flat = restored["masters"][f"leaf{i}"].reshape(-1)
                if self.nvme_params:
                    self.param_tier.write_master(i, flat)
                else:
                    self.masters[i].copy_(flat)
        if not optimizer:
            return
        self.step_count = int(restored["step"])
        n = len(self.leaf_sizes)
        if self.sq_sum is not None:
            for i, s in enumerate(self.sq_sum):
                s.copy_(restored["sq_sum"][f"leaf{i}"].reshape(-1))
        elif "m" not in restored:
            moments()
        elif self.nvme is not None:
            self.nvme.write_moments([restored["m"][f"leaf{i}"] for i in range(n)],
                                    [restored["v"][f"leaf{i}"] for i in range(n)])
        else:
            self.opt.load_state_dict({"step": self.step_count,
                                      "m": [restored["m"][f"leaf{i}"] for i in range(n)],
                                      "v": [restored["v"][f"leaf{i}"] for i in range(n)]})
        if "scaler" in restored and self.scaler_state is not None:
            v = restored["scaler"].tolist()
            self.scaler_state = LossScaleState(
                cur_scale=torch.tensor(v[0], dtype=torch.float32),
                cur_hysteresis=torch.tensor(int(v[1]), dtype=torch.int32),
                last_overflow_iter=torch.tensor(int(v[2]), dtype=torch.int32),
                iteration=torch.tensor(int(v[3]), dtype=torch.int32))

    def load_state_dict(self, sd: dict) -> None:
        """Install a whole :meth:`state_dict` (checked first)."""
        self._check(sd, self._template(True, in_memory=True), "state_dict")
        self._install(sd, True)

    def load_from(self, checkpoint_engine, path: str,
                  load_optimizer_states: bool = True) -> None:
        """Masters always; the step, moments (or sums) and loss scaler with
        ``load_optimizer_states`` (JAX ``:1102-1150``). Everything is read and
        checked (names, shapes, dtypes; the files' sizes) before anything is
        installed."""
        restored = checkpoint_engine.load(path)
        self._check(restored, self._template(load_optimizer_states, in_memory=False), path)
        moments = None
        if load_optimizer_states and self.nvme is not None:
            sizes = self.nvme.check_files(path + "_moments")

            def moments():
                self.nvme.copy_files_from(path + "_moments", sizes)
        if self.nvme_params:
            self.param_tier.check_masters(path + "_masters")
            self.param_tier.copy_masters_from(path + "_masters")
        self._install(restored, load_optimizer_states, moments)
