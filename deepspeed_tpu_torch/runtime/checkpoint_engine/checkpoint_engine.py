"""Checkpoint storage with crash-consistent commits.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``
(the reference's ``CheckpointEngine`` and ``torch_checkpoint_engine.py``). The
commit protocol, its file names and its fault sites are the JAX package's:

1. a tag's data is staged into ``<save_dir>/<tag>.tmp/`` (``begin_tag``);
2. ``commit_tag`` drains the writer, writes a SHA-256 manifest of every staged
   file (``manifest.json``), fsyncs them, and publishes the tag with one
   ``os.rename(<tag>.tmp, <tag>)`` and a parent-directory fsync;
3. the ``latest`` pointer is written (atomically) only after the rename.

A kill at any point leaves either the previous committed tag intact (the
staging directory is ignored by tag discovery and reclaimed by the next
``begin_tag``) or the new tag fully visible. :func:`validate_manifest` raises
:class:`CheckpointCorruptionError` naming the first file that is missing,
truncated or corrupt; :func:`find_latest_committed_tag` is the fallback when
``latest`` names a torn tag.

Where the JAX package writes arrays with Orbax, :class:`TorchCheckpointEngine`
writes a tree of tensors as torch files: every dict of tensors (and every lone
tensor) in the tree is one shard, ``<path>/<dotted tree path>.pt``, written
with ``torch.save`` from host copies taken before ``save`` returns and read
back with ``torch.load(weights_only=True)``. Side data goes to ``.pkl`` and
``.json`` files. With ``async_save`` the shard writes of one save run on a
writer thread; ``commit`` (inside ``commit_tag``) waits for them.
"""

import hashlib
import json
import os
import pickle
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from ...utils.fault_injection import fault_point, retry_with_backoff
from ...utils.logging import logger

TMP_SUFFIX = ".tmp"
OLD_SUFFIX = ".old"       # graveyard for a re-saved tag's previous directory
MANIFEST_FILE = "manifest.json"
LATEST_FILE = "latest"
SHARD_SUFFIX = ".pt"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed manifest/checksum validation or could not be read;
    the message names the offending file and the failure mode."""


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; the rename is still ordered
    finally:
        os.close(fd)


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            blk = f.read(chunk)
            if not blk:
                break
            h.update(blk)
    return h.hexdigest()


def _walk_files(root: str) -> List[str]:
    """Relative paths of every regular file under ``root`` (sorted, manifest
    excluded)."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel != MANIFEST_FILE:
                out.append(rel)
    return sorted(out)


def write_manifest(tag_dir: str, tag: str, fsync: bool = True) -> Dict[str, Any]:
    """Per-file SHA-256 manifest over every file in ``tag_dir``. Written last
    (its presence marks a complete data set) and atomically (tmp + rename)."""
    files = {}
    for rel in _walk_files(tag_dir):
        full = os.path.join(tag_dir, rel)
        fault_point("ckpt.manifest.hash")
        files[rel] = {"sha256": _sha256_file(full),
                      "size": os.path.getsize(full)}
        if fsync:
            _fsync_file(full)
    manifest = {"version": 1, "tag": str(tag), "files": files,
                "committed_at": time.time()}
    tmp = os.path.join(tag_dir, MANIFEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.rename(tmp, os.path.join(tag_dir, MANIFEST_FILE))
    if fsync:
        _fsync_dir(tag_dir)
    return manifest


def validate_manifest(tag_dir: str, strict: bool = False):
    """Validate every file in ``tag_dir`` against its manifest.

    Raises :class:`CheckpointCorruptionError` on a missing, truncated or
    corrupt file (named in the message). A missing manifest is tolerated with
    a warning (a checkpoint written before manifests) unless ``strict``.
    """
    mpath = os.path.join(tag_dir, MANIFEST_FILE)
    if not os.path.isfile(mpath):
        if strict:
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir} has no {MANIFEST_FILE} — it was never "
                "committed (torn write?)")
        logger.warning(f"[ckpt] {tag_dir} has no {MANIFEST_FILE}; skipping "
                       "integrity validation (pre-manifest checkpoint?)")
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint manifest {mpath} is unreadable: {e}") from e
    for rel, meta in manifest.get("files", {}).items():
        full = os.path.join(tag_dir, rel)
        if not os.path.isfile(full):
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir}: shard {rel!r} is missing")
        size = os.path.getsize(full)
        if size != meta["size"]:
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir}: shard {rel!r} truncated "
                f"({size} bytes, manifest says {meta['size']})")
        if _sha256_file(full) != meta["sha256"]:
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir}: shard {rel!r} failed its SHA-256 "
                "checksum — the file is corrupt")


def is_committed_tag(save_dir: str, tag: str) -> bool:
    """A tag is committed iff its final directory exists with a readable
    manifest (staging and graveyard directories never are)."""
    tag_dir = os.path.join(save_dir, str(tag))
    if not os.path.isdir(tag_dir) or str(tag).endswith(TMP_SUFFIX) \
            or str(tag).endswith(OLD_SUFFIX):
        return False
    mpath = os.path.join(tag_dir, MANIFEST_FILE)
    if not os.path.isfile(mpath):
        # pre-manifest checkpoint: committed if the dir simply exists
        return True
    try:
        with open(mpath) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def find_latest_committed_tag(save_dir: str,
                              exclude: Optional[str] = None) -> Optional[str]:
    """Newest committed tag under ``save_dir`` by manifest commit time (file
    mtime fallback), skipping ``exclude`` and staging dirs — the fallback when
    the ``latest`` pointer names a torn checkpoint."""
    best, best_t = None, -1.0
    try:
        entries = os.listdir(save_dir)
    except OSError:
        return None
    for name in entries:
        if name == str(exclude) or name.endswith(TMP_SUFFIX) \
                or name.endswith(OLD_SUFFIX):
            continue
        mpath = os.path.join(save_dir, name, MANIFEST_FILE)
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath) as f:
                t = float(json.load(f).get("committed_at", 0.0))
        except (OSError, ValueError):
            continue
        t = t or os.path.getmtime(mpath)
        if t > best_t:
            best, best_t = name, t
    return best


def resolve_tag_dir(ckpt_dir: str, tag: Optional[str] = None) -> str:
    """The directory of ``tag`` under ``ckpt_dir``; without a tag, the one
    ``latest`` names, else ``ckpt_dir`` itself (a tag's directory). No
    fallback: the readers that take a tag this way (``zero_to_fp32``, the
    inference engine) validate it, as the JAX package's do not."""
    if tag is None:
        latest = os.path.join(ckpt_dir, LATEST_FILE)
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
    return os.path.join(ckpt_dir, tag) if tag else ckpt_dir


def write_latest_pointer(save_dir: str, tag: str):
    """Atomic ``latest`` update: tmp + fsync + rename (a crash mid-update leaves
    the previous pointer intact)."""
    fault_point("ckpt.latest")
    tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(save_dir, LATEST_FILE))
    _fsync_dir(save_dir)


class CheckpointEngine:
    """save/load/commit surface, mirroring the reference ABC, plus the atomic
    tag staging protocol (``begin_tag``/``commit_tag``). ``timings`` holds the
    seconds of the current save (from ``begin_tag``) by phase: ``write_s``,
    ``drain_s`` (waiting for the writer), ``manifest_s`` (hashing and fsync)
    and ``rename_s``; the backend adds its own."""

    def __init__(self, config_params=None):
        self.config = config_params
        self._staging: Dict[str, str] = {}   # tag -> staged dir
        self.timings: Dict[str, float] = {}
        self._timings_lock = threading.Lock()   # a writer thread adds its own

    def add_time(self, key: str, t0: float) -> None:
        """Add the seconds since ``t0`` (``time.perf_counter``) to ``timings[key]``."""
        dt = time.perf_counter() - t0
        with self._timings_lock:
            self.timings[key] = self.timings.get(key, 0.0) + dt

    def create(self, tag: str):
        logger.info(f"[ckpt] start checkpoint {tag}")

    def save(self, state_dict: Any, path: str):
        raise NotImplementedError

    def load(self, path: str) -> Any:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        logger.info(f"[ckpt] checkpoint {tag} ready")
        return True

    # ------------------------------------------------------------ atomic tags
    def staging_path(self, save_dir: str, tag: str) -> str:
        """Where ``begin_tag`` stages this tag's data."""
        return os.path.join(save_dir, f"{tag}{TMP_SUFFIX}")

    def begin_tag(self, save_dir: str, tag: str) -> str:
        """Open a staging directory ``<save_dir>/<tag>.tmp`` for this tag's data
        (leftover staging from a crashed save is reclaimed)."""
        self.timings = {}
        os.makedirs(save_dir, exist_ok=True)
        staged = self.staging_path(save_dir, tag)
        if os.path.isdir(staged):
            logger.warning(f"[ckpt] reclaiming stale staging dir {staged} "
                           "(previous save died mid-write)")
            shutil.rmtree(staged, ignore_errors=True)
        # a crash during a re-save of this tag can strand its graveyard copy
        grave = os.path.join(save_dir, f"{tag}{OLD_SUFFIX}")
        if os.path.isdir(grave):
            logger.warning(f"[ckpt] reclaiming stale graveyard dir {grave}")
            shutil.rmtree(grave, ignore_errors=True)
        os.makedirs(staged, exist_ok=True)
        self._staging[str(tag)] = staged
        self.create(tag)
        return staged

    def commit_tag(self, save_dir: str, tag: str) -> str:
        """Drain the writer, manifest + fsync the staged data, and publish the
        tag with one atomic rename. Returns the final tag directory."""
        staged = self._staging.pop(str(tag), None)
        if staged is None:
            staged = self.staging_path(save_dir, tag)
        if not os.path.isdir(staged):
            raise FileNotFoundError(
                f"commit_tag({tag!r}): no staged checkpoint at {staged} — "
                "begin_tag was never called or the staging dir was removed")
        t0 = time.perf_counter()
        self.commit(tag)                       # the writer's last shard lands first
        self.add_time("drain_s", t0)
        t0 = time.perf_counter()
        fault_point("ckpt.commit.manifest")
        write_manifest(staged, tag)
        self.add_time("manifest_s", t0)
        t0 = time.perf_counter()
        final = os.path.join(save_dir, str(tag))
        if os.path.isdir(final):
            # re-saving an existing tag: move the old one to a graveyard first so
            # readers never see a half-deleted tag (a graveyard stranded by a crash
            # here is reclaimed by the next begin_tag and ignored by discovery)
            grave = final + OLD_SUFFIX
            shutil.rmtree(grave, ignore_errors=True)
            os.rename(final, grave)
            shutil.rmtree(grave, ignore_errors=True)
        fault_point("ckpt.commit.rename")
        os.rename(staged, final)
        _fsync_dir(save_dir)
        self.add_time("rename_s", t0)
        logger.info(f"[ckpt] committed {tag} -> {final}")
        return final


def _shards(tree: Dict[str, Any], prefix: str = ""):
    """``(dotted tree path, value)`` of every shard of ``tree``: each dict whose
    values are all tensors, and each tensor outside such a dict. A top-level
    entry is always a shard of its own (or several)."""
    for key, value in tree.items():
        key = str(key)
        if not key or "." in key or os.sep in key:
            raise ValueError(f"checkpoint tree key {key!r} under {prefix!r} must be a "
                             "non-empty name without '.' or a path separator")
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, torch.Tensor) or (
                isinstance(value, dict) and all(isinstance(v, torch.Tensor)
                                                for v in value.values())):
            yield name, value
        elif isinstance(value, dict):
            yield from _shards(value, name)
        else:
            raise TypeError(f"checkpoint tree entry {name!r} is a {type(value).__name__}, "
                            "not a tensor or a dict")


def _host_copy(value):
    """A host copy that nothing else holds: the engine updates its device (or,
    on the CPU, host) tensors in place at the next step."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return {k: v.detach().to("cpu", copy=True) for k, v in value.items()}


class TorchCheckpointEngine(CheckpointEngine):
    """Tensor trees as torch files, side data as pickle or JSON.

    ``save(tree, path)`` with a path ending in ``.pkl``/``.json`` writes side
    data; any other path is a directory of shards (see the module docstring).
    Every write and read goes through :func:`retry_with_backoff`, so a
    transient I/O error does not fail a save or load that could succeed (the
    writes are idempotent: each rewrites a whole file). A file that cannot be
    read raises :class:`CheckpointCorruptionError` naming it.
    """

    IO_RETRIES = 2
    IO_BASE_DELAY = 0.05

    def __init__(self, config_params=None, use_async: bool = False):
        super().__init__(config_params)
        self.use_async = use_async
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def _retry(self, fn):
        return retry_with_backoff(fn, retries=self.IO_RETRIES,
                                  base_delay=self.IO_BASE_DELAY, retryable=(OSError,))

    # ------------------------------------------------------------------ save
    def save(self, state_dict: Any, path: str):
        fault_point("ckpt.save")
        if path.endswith(".json") or path.endswith(".pkl"):
            def write_side():
                fault_point("ckpt.save.io")
                if path.endswith(".json"):
                    with open(path, "w") as f:
                        json.dump(state_dict, f, indent=2, default=str)
                else:
                    with open(path, "wb") as f:
                        pickle.dump(state_dict, f)
            self._retry(write_side)
            return
        t0 = time.perf_counter()
        host = [(name, _host_copy(value)) for name, value in _shards(state_dict)]
        self.add_time("d2h_s", t0)
        os.makedirs(path, exist_ok=True)
        for name, value in host:
            target = os.path.join(path, name + SHARD_SUFFIX)
            if self.use_async:
                if self._writer is None:
                    self._writer = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="ds-ckpt-writer")
                self._pending.append(self._writer.submit(self._write_shard, value, target))
            else:
                self._write_shard(value, target)

    def _write_shard(self, value, target: str) -> None:
        t0 = time.perf_counter()

        def write():
            fault_point("ckpt.save.io")
            torch.save(value, target)
        self._retry(write)
        self.add_time("write_s", t0)

    def commit(self, tag: str) -> bool:
        """Wait for every pending shard write; the first failure raises."""
        pending, self._pending = self._pending, []
        errors = [f.exception() for f in pending]
        errors = [e for e in errors if e is not None]
        if errors:
            raise errors[0]
        return super().commit(tag)

    # ------------------------------------------------------------------ load
    def _read(self, path: str, read):
        def attempt():
            fault_point("ckpt.load.io")
            return read()
        try:
            return self._retry(attempt)
        except OSError:
            raise
        except Exception as e:
            raise CheckpointCorruptionError(f"checkpoint file {path} is unreadable: "
                                            f"{type(e).__name__}: {e}") from e

    def _shard_files(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            raise CheckpointCorruptionError(f"checkpoint state {path} is missing")
        files = sorted(f for f in os.listdir(path) if f.endswith(SHARD_SUFFIX))
        if not files:
            raise CheckpointCorruptionError(f"checkpoint state {path} holds no shard")
        return files

    def _load_shards(self, path: str, files: List[str]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        tree: Dict[str, Any] = {}
        for name in files:
            full = os.path.join(path, name)
            value = self._read(full, lambda: torch.load(full, map_location="cpu",
                                                        weights_only=True))
            *parents, leaf = name[:-len(SHARD_SUFFIX)].split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
        self.add_time("read_s", t0)
        return tree

    def load(self, path: str) -> Any:
        """The side data at a ``.pkl``/``.json`` path, else the tree of host
        tensors under the shard directory ``path``."""
        fault_point("ckpt.load")
        if path.endswith(".json") or path.endswith(".pkl"):
            def read_side():
                if path.endswith(".json"):
                    with open(path) as f:
                        return json.load(f)
                with open(path, "rb") as f:
                    return pickle.load(f)
            return self._read(path, read_side)
        return self._load_shards(path, self._shard_files(path))

    def load_subtree(self, path: str, key: str) -> Any:
        """One top-level entry (e.g. ``params``) of the tree under ``path``,
        reading only its shards (the inference engine's load)."""
        fault_point("ckpt.load")
        files = [f for f in self._shard_files(path)
                 if f == key + SHARD_SUFFIX or f.startswith(key + ".")]
        if not files:
            raise CheckpointCorruptionError(f"checkpoint state {path} holds no {key!r} "
                                            f"entry (shards: {self._shard_files(path)})")
        return self._load_shards(path, files)[key]


def make_checkpoint_engine(checkpoint_config=None) -> CheckpointEngine:
    use_async = bool(getattr(checkpoint_config, "async_save", False))
    return TorchCheckpointEngine(checkpoint_config, use_async=use_async)
