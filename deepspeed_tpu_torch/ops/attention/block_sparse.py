"""Block-sparse attention: the hand-written Hopper kernels
``csrc/block_sparse_fwd.cu``, ``csrc/block_sparse_bwd_dq.cu`` and
``csrc/block_sparse_bwd_dkv.cu``, their plain PyTorch versions, the autograd
Function that joins them, and the attention impl a model takes.

Counterpart of ``deepspeed_tpu/ops/attention/block_sparse.py``
(``build_tables``, ``_bs_fwd`` / ``_fwd_kernel``, ``_bs_bwd`` /
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``, the ``_bs_core`` custom VJP, public
``block_sparse_attention``, ``block_sparse_attention_reference`` and
``make_sparse_attention_impl``). A ``SparsityConfig``
(``ops/sparse_attention``) gives an ``(H, nb, nb)`` block layout; the kernels
compute attention over its active blocks only. Each (b*h, q-block) walks its
row of the forward table (``fwd_idx``, ``fwd_cnt``) in ascending k-block order
with an online softmax; the dk/dv kernel walks the transposed table
(``bwd_idx``, ``bwd_cnt``: the q-blocks that attend to each k-block). The
head of row block ``i`` is ``i % n_heads``. With ``causal`` the triangle
applies inside the blocks.

Masking follows the TPU kernel exactly, not the dense reference: the running
max starts at -1e30 and masked scores are the finite -1e30, so a row whose
active blocks all lie past the diagonal gets the mean of those blocks' V rows
(p = exp(0) = 1) with an lse of about -1e30, and a row with no active block
gets zeros and an lse of -1e30. The dense reference gives the mean of all V
rows in both cases; every shipped config holds the diagonal block in every
row, so only hand-made layouts meet them.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors. The kernels take a head_dim that is a multiple of 8 up to 128
(``flash.kernel_width`` in training mode: the 64- or 128-wide build, with the
real head_dim at run time) and a layout block of 16, 32, 64 or 128 (anything
else raises ``ValueError``), in f32, fp16 or bf16
with f32 sums. The forward kernel writes through raw pointers, so its output
has no autograd history: :func:`block_sparse_fwd` refuses CUDA inputs that
require grad while grad mode is on, and :class:`BlockSparseAttnFunction` is
the differentiable way in.

The forward and dq kernels' bf16/fp16 paths walk tiles of 64 q rows a
consumer warpgroup, not single q-blocks: they take the tile tables of
:func:`build_tile_tables` (the union of a tile's q-blocks' k-blocks, with a
bitmask of the q-blocks that own each). The dk/dv kernel's bf16/fp16 path
walks tiles of 64 k rows the same way over the transposed layout, whose
k-blocks :func:`build_bwd_tile_tables` groups by their walks. Both are built
on the host once per length and cached on the device by
:func:`make_sparse_attention_impl`.
"""

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..op_builder import CudaKernel
from ..sparse_attention.sparsity_config import SparsityConfig, layout_to_dense_mask
from .flash import DTYPE_CODES, NEG_INF, kernel_width

BLOCKS = (16, 32, 64, 128)
TABLE_NAMES = ("fwd_idx", "fwd_cnt", "bwd_idx", "bwd_cnt")
#: q rows a tile of the forward kernel's bf16/fp16 path (one consumer warpgroup)
TILE_ROWS = 64

_vp, _int = ctypes.c_void_p, ctypes.c_int
BLOCK_SPARSE_FWD = CudaKernel(
    "block_sparse_fwd", "block_sparse_fwd.cu", "block_sparse_fwd",
    [_vp, _vp, _vp, _vp, _vp,                 # q, k, v, idx, cnt
     _vp, _vp, _vp, _vp, _vp,                 # tile_idx, tile_cnt, tile_order, o, lse
     _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
     _int,                                    # max_slots
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream
BLOCK_SPARSE_BWD_DQ = CudaKernel(
    "block_sparse_bwd_dq", "block_sparse_bwd_dq.cu", "block_sparse_bwd_dq",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,  # q, k, v, do, lse, delta, idx, cnt
     _vp, _vp, _vp, _vp,                      # tile_idx, tile_cnt, tile_order, dq
     _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
     _int,                                    # max_slots
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream
BLOCK_SPARSE_BWD_DKV = CudaKernel(
    "block_sparse_bwd_dkv", "block_sparse_bwd_dkv.cu", "block_sparse_bwd_dkv",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,  # q, k, v, do, lse, delta, idx, cnt
     _vp, _vp, _vp, _vp,                      # members, tile_idx, tile_cnt, tile_order
     _vp, _vp,                                # dk, dv
     _int, _int, _int, _int, _int, _int,      # bh, t, d, n_heads, block, max_n
     _int,                                    # max_slots
     ctypes.c_float, _int, _int, _vp])        # scale, causal, dtype, stream


# ------------------------------------------------------------------ layout tables
def build_tables(layout: np.ndarray) -> Dict[str, np.ndarray]:
    """Active-block index tables from a (H, nb, nb) 0/1 layout.

    ``fwd_idx[h, qi, n]`` = n-th active k-block for q-block ``qi`` (pad 0),
    ``fwd_cnt[h, qi]`` = number of active k-blocks; ``bwd_*`` the transpose
    (q-blocks per k-block). All int32, as the JAX package builds them."""
    layout = np.asarray(layout) != 0
    h, nb, _ = layout.shape
    fwd_cnt = layout.sum(axis=2).astype(np.int32)
    bwd_cnt = layout.sum(axis=1).astype(np.int32)
    max_f = max(1, int(fwd_cnt.max()))
    max_b = max(1, int(bwd_cnt.max()))
    fwd_idx = np.zeros((h, nb, max_f), np.int32)
    bwd_idx = np.zeros((h, nb, max_b), np.int32)
    for hi in range(h):
        for qi in range(nb):
            nz = np.nonzero(layout[hi, qi])[0]
            fwd_idx[hi, qi, :len(nz)] = nz
        for ki in range(nb):
            nz = np.nonzero(layout[hi, :, ki])[0]
            bwd_idx[hi, ki, :len(nz)] = nz
    return {"fwd_idx": fwd_idx, "fwd_cnt": fwd_cnt,
            "bwd_idx": bwd_idx, "bwd_cnt": bwd_cnt}


class TileTables(NamedTuple):
    """The forward kernel's tile tables (:func:`build_tile_tables`), numpy
    arrays or, after :meth:`to`, int32 tensors on a device."""
    idx: Any        # (H, n_tiles, max_slots): entries k_unit << 8 | owner bits
    cnt: Any        # (H, n_tiles): union entries a tile
    order: Any      # (H * n_tiles,): head * n_tiles + tile, the longest walks first

    def to(self, device) -> "TileTables":
        return TileTables(*_on_device(self, device))


class BwdTileTables(NamedTuple):
    """The dk/dv kernel's tile tables (:func:`build_bwd_tile_tables`): the
    forward's entry format over the transposed layout, with each tile's
    member k-units."""
    members: Any    # (H, n_tiles, 64 / unit): the tile's k-units, -1 past the last
    idx: Any        # (H, n_tiles, max_slots): entries q_unit << 8 | member bits
    cnt: Any        # (H, n_tiles): union entries a tile
    order: Any      # (H * n_tiles,): head * n_tiles + tile, the longest walks first

    def to(self, device) -> "BwdTileTables":
        return BwdTileTables(*_on_device(self, device))


def _on_device(arrays, device):
    return (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays)


def _units(layout: np.ndarray, block: int) -> Tuple[np.ndarray, int]:
    """The 0/1 layout as bool in units of ``min(block, 64)`` rows (a layout
    of block 128 expanded: each 128-block is 2 x 2 of them), and the unit."""
    if block not in BLOCKS:
        raise ValueError(f"the tile tables take a layout block in {BLOCKS}, got {block}")
    layout = np.asarray(layout) != 0
    unit = min(block, 64)
    if block > unit:
        layout = layout.repeat(block // unit, 1).repeat(block // unit, 2)
    return layout, unit


def _tile_walks(owners: np.ndarray, slots: int):
    """``(idx, cnt, order)`` of tiles whose rows own ``owners`` ``(H,
    n_tiles, rows, nu)`` bool: each tile's ascending union of owned units,
    entries ``unit << 8 | bits`` (bit g: the tile's row g owns it), padded to
    whole stages of ``slots`` with a repeat of the last real unit owned by no
    row; the union's size; the (head, tile) pairs by stage count, longest
    first (stable)."""
    h, n_tiles, rows, _ = owners.shape
    bits = (owners.astype(np.int64) << np.arange(rows)[None, None, :, None]).sum(2)
    cnt = (bits != 0).sum(-1)
    stages = -(-cnt // slots)
    idx = np.zeros((h, n_tiles, max(1, int(stages.max())) * slots), np.int32)
    for hi in range(h):
        for ti in range(n_tiles):
            units = np.nonzero(bits[hi, ti])[0]
            if len(units):
                idx[hi, ti, :len(units)] = units << 8 | bits[hi, ti, units]
                idx[hi, ti, len(units):stages[hi, ti] * slots] = units[-1] << 8
    order = np.argsort(-stages.reshape(-1), kind="stable").astype(np.int32)
    return idx, cnt.astype(np.int32), order


def build_tile_tables(layout: np.ndarray, block: int) -> TileTables:
    """The walk of the forward kernel's bf16/fp16 path from a (H, nb, nb) 0/1
    layout of block ``block``, for tiles of ``TILE_ROWS`` (64) q rows.

    The kernel works in units of ``unit = min(block, 64)`` rows; a layout of
    block 128 is first expanded to 64-row units (each 128-block is 2 x 2 of
    them). A tile is ``64 / unit`` consecutive q-units and a stage ``64 /
    unit`` k-units (64 columns). For each (head, tile), ``idx`` holds the
    ascending union of the k-units its q-units own, each entry ``k_unit << 8
    | bits`` with bit g set where the tile's q-unit g owns it, padded to whole
    stages with a repeat of the last real k-unit owned by no q-unit (so every
    slot of a stage is loaded); ``cnt`` the union's size; ``order`` the
    (head, tile) pairs by stage count, longest first (stable)."""
    layout, unit = _units(layout, block)
    h, nu, _ = layout.shape
    per_tile = TILE_ROWS // unit
    n_tiles = -(-nu // per_tile)
    owners = np.zeros((h, n_tiles * per_tile, nu), bool)
    owners[:, :nu] = layout
    return TileTables(*_tile_walks(owners.reshape(h, n_tiles, per_tile, nu), per_tile))


def _member_owners(lt: np.ndarray, members: np.ndarray) -> np.ndarray:
    """``(n_tiles, rows, nq)``: the q-units that attend to each member k-unit
    of one head's transposed layout ``lt`` ``(nk, nq)``; none for a -1."""
    return np.where(members[..., None] >= 0, lt[members.clip(0)], False)


def build_bwd_tile_tables(layout: np.ndarray, block: int) -> BwdTileTables:
    """The walk of the dk/dv kernel's bf16/fp16 path from a (H, nb, nb) 0/1
    layout of block ``block``, for tiles of ``TILE_ROWS`` (64) k rows.

    The layout is transposed (row k-unit, column the q-units that attend to
    it) and taken in units as :func:`build_tile_tables` takes it. A tile is
    ``64 / unit`` k-units of one head, not necessarily consecutive: of two
    groupings, each head takes the one whose tiles walk fewer stages (the
    first on a tie): consecutive k-units, or the k-units sorted by how many
    q-units attend to them (most first), then by the first that does, then
    by position. At block 16 under a Fixed layout that puts the global
    columns, which every later q-unit attends to, into tiles of their own
    instead of into every window's union. ``members`` lists each tile's
    k-units (-1 where the last tile holds fewer); ``idx``, ``cnt`` and
    ``order`` are :func:`build_tile_tables`' over the members, each entry
    ``q_unit << 8 | bits`` with bit g set where member g is attended by that
    q-unit."""
    layout, unit = _units(layout, block)
    lt = layout.transpose(0, 2, 1)
    h, nu, _ = lt.shape
    per_tile = slots = TILE_ROWS // unit
    n_tiles = -(-nu // per_tile)
    walk = lt.sum(2)
    first = np.where(walk > 0, lt.argmax(2), nu)
    members = np.full((h, n_tiles, per_tile), -1, np.int64)
    for hi in range(h):
        best = None
        for units in (np.arange(nu), np.lexsort((np.arange(nu), first[hi], -walk[hi]))):
            m = np.full(n_tiles * per_tile, -1, np.int64)
            m[:nu] = units
            m = m.reshape(n_tiles, per_tile)
            stages = int((-(-_member_owners(lt[hi], m).any(1).sum(-1) // slots)).sum())
            if best is None or stages < best[0]:
                best = (stages, m)
        members[hi] = best[1]
    owners = np.stack([_member_owners(lt[hi], members[hi]) for hi in range(h)])
    return BwdTileTables(members.astype(np.int32), *_tile_walks(owners, slots))


def kernel_tile_tables(layout: np.ndarray, block: int, device, backward: bool = False):
    """:func:`build_tile_tables` (``backward``: :func:`build_bwd_tile_tables`)
    on ``device`` for the kernels of :func:`block_sparse_fwd` and
    :func:`block_sparse_bwd_dq` (of :func:`block_sparse_bwd_dkv`); None on the
    CPU, where no kernel runs, and for a block the kernel refuses (the wrapper
    says why). The kernels' float32 paths ignore them."""
    if torch.device(device).type != "cuda" or block not in BLOCKS:
        return None
    build = build_bwd_tile_tables if backward else build_tile_tables
    return build(layout, block).to(device)


def device_tables(tables: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """:func:`build_tables`' arrays as contiguous int32 tensors on ``device``."""
    return {name: torch.from_numpy(np.ascontiguousarray(tables[name])).to(device)
            for name in TABLE_NAMES}


def table_layout(idx: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The ``(H, nb, nb)`` bool layout a table walks: ``[h, i, idx[h, i, n]]``
    for ``n < cnt[h, i]`` (a forward table gives the layout, a backward one
    its transpose)."""
    h, nb, max_n = idx.shape
    walked = torch.arange(max_n, device=idx.device) < cnt[..., None].long()
    hi, ri, ni = walked.nonzero(as_tuple=True)
    out = torch.zeros(h, nb, nb, dtype=torch.bool, device=idx.device)
    out[hi, ri, idx[hi, ri, ni].long()] = True
    return out


# ------------------------------------------------------------------ checks
def _scale(q3: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(q3.shape[-1]))


def _check(name, tensors, idx, cnt, block, n_heads) -> None:
    """Shapes and types every caller must meet, on either device. ``tensors``
    are the ``(b*h, t, d)`` inputs of one dtype; the table is ``(n_heads, t /
    block, max_n)`` with its counts ``(n_heads, t / block)``, both int32."""
    q3 = tensors[0]
    if q3.ndim != 3 or any(x.shape != q3.shape for x in tensors):
        raise ValueError(f"{name}: q/k/v/do must share one (b*h, t, d) shape, got "
                         f"{[tuple(x.shape) for x in tensors]}")
    if any(x.dtype != q3.dtype for x in tensors) or q3.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: q/k/v/do must share one of {list(DTYPE_CODES)}, got "
                        f"{[x.dtype for x in tensors]}")
    bh, t, _ = q3.shape
    if n_heads <= 0 or bh % n_heads:
        raise ValueError(f"{name}: b*h={bh} is not a multiple of n_heads={n_heads}")
    if block <= 0 or t % block:
        raise ValueError(f"{name}: the layout block {block} does not divide t={t}")
    nb = t // block
    if idx.ndim != 3 or tuple(idx.shape[:2]) != (n_heads, nb) or \
            tuple(cnt.shape) != (n_heads, nb):
        raise ValueError(f"{name}: tables must be ({n_heads}, {nb}, max_n) and "
                         f"({n_heads}, {nb}), got {tuple(idx.shape)}, {tuple(cnt.shape)}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"{name}: tables must be int32, got {idx.dtype}, {cnt.dtype}")
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q3.device}")


def _check_cuda(name, tensors, block) -> None:
    """What the CUDA kernels take: a head_dim :func:`kernel_width` accepts
    for training, a layout block in ``BLOCKS``, contiguous 16-byte-aligned
    tensors (tables included) on one device."""
    kernel_width(tensors[0].shape[-1], training=True)
    if block not in BLOCKS:
        raise ValueError(f"{name} kernel takes a layout block in {BLOCKS}, got {block}")
    device = tensors[0].device
    if not all(x.device == device and x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte-aligned inputs and "
                         f"tables on one device")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------------------------------ kernels
#: tile tables found to walk a table: tiles.idx -> (idx, cnt)
_TILES_MATCHED = WeakIdKeyDictionary()


def _walked(tiles, block: int):
    """``(hi, ti, si, g, unit)``: every (head, tile, slot, row g) of the
    stages the kernel walks whose entry has bit g set, and the entry's unit;
    None if a walked entry is negative."""
    slots = TILE_ROWS // min(block, 64)
    _, _, max_slots = tiles.idx.shape
    dev = tiles.idx.device
    walked_slots = -(-tiles.cnt.long() // slots) * slots
    live = torch.arange(max_slots, device=dev) < walked_slots[..., None]
    if bool((walked_slots > max_slots).any()) or bool(((tiles.idx < 0) & live).any()):
        return None
    ents = tiles.idx.long() * live
    owns = (ents[..., None] >> torch.arange(slots, device=dev)) & 1
    hi, ti, si, g = owns.nonzero(as_tuple=True)
    return hi, ti, si, g, ents[hi, ti, si] >> 8


def _want(idx: torch.Tensor, cnt: torch.Tensor, block: int, device) -> torch.Tensor:
    """The layout a table walks, in units of ``min(block, 64)`` rows."""
    rep = block // min(block, 64)
    want = table_layout(idx, cnt).to(device)
    return want.repeat_interleave(rep, 1).repeat_interleave(rep, 2).long()


def _tiles_walk_table(tiles: TileTables, fwd_idx: torch.Tensor, fwd_cnt: torch.Tensor,
                      block: int) -> bool:
    """Whether the stages the kernel walks of ``tiles`` own each (q-unit,
    k-unit) pair of the forward table's layout exactly once and nothing
    else (units of ``min(block, 64)`` rows), on the tables' device."""
    per_tile = TILE_ROWS // min(block, 64)
    h, n_tiles, _ = tiles.idx.shape
    want = _want(fwd_idx, fwd_cnt, block, tiles.idx.device)
    nu = want.shape[1]
    found = _walked(tiles, block)
    if found is None or bool((found[4] >= nu).any()):
        return False
    hi, ti, _, g, k_unit = found
    walked = torch.zeros(h, n_tiles * per_tile, nu, dtype=torch.long, device=want.device)
    walked.index_put_((hi, ti * per_tile + g, k_unit), torch.ones_like(k_unit), accumulate=True)
    return torch.equal(walked[:, :nu], want) and not bool(walked[:, nu:].any())


def _bwd_tiles_walk_table(tiles: BwdTileTables, bwd_idx: torch.Tensor, bwd_cnt: torch.Tensor,
                          block: int) -> bool:
    """Whether ``tiles``' members hold each k-unit of a head once, and the
    stages the kernel walks attend each (k-unit, q-unit) pair of the
    transposed table's layout to its member exactly once and nothing else
    (units of ``min(block, 64)`` rows), on the tables' device."""
    want = _want(bwd_idx, bwd_cnt, block, tiles.idx.device)
    h, nu, _ = want.shape
    members = tiles.members.long().reshape(h, -1)
    if bool((members < -1).any()) or bool((members >= nu).any()):
        return False
    held = torch.zeros(h, nu + 1, dtype=torch.long, device=want.device)
    held.scatter_add_(1, members % (nu + 1), torch.ones_like(members))
    found = _walked(tiles, block)
    if not bool((held[:, :nu] == 1).all()) or found is None or bool((found[4] >= nu).any()):
        return False
    hi, ti, _, g, q_unit = found
    k_unit = tiles.members.long()[hi, ti, g]
    if bool((k_unit < 0).any()):
        return False
    walked = torch.zeros(h, nu, nu, dtype=torch.long, device=want.device)
    walked.index_put_((hi, k_unit, q_unit), torch.ones_like(k_unit), accumulate=True)
    return torch.equal(walked, want)


def _check_tiles(name: str, tiles, q3: torch.Tensor, idx: torch.Tensor, cnt: torch.Tensor,
                 block: int, n_heads: int) -> None:
    """Tile tables must fit the kernel (:func:`build_tile_tables`' or
    :func:`build_bwd_tile_tables`' sizes) and walk the layout of the table
    the kernel's float32 path walks (the forward's, or the transposed one of
    the dk/dv kernel). That walk is compared once per pair of tables (one
    read back to the host), so later calls with the same tensors read
    nothing back."""
    if block not in BLOCKS:
        raise ValueError(f"{name} kernel takes a layout block in {BLOCKS}, got {block}")
    bh, t, _ = q3.shape
    n_tiles = -(-t // TILE_ROWS)
    slots = TILE_ROWS // min(block, 64)
    backward = isinstance(tiles, BwdTileTables)
    if tuple(tiles.cnt.shape) != (n_heads, n_tiles) or tiles.idx.ndim != 3 or \
            tuple(tiles.idx.shape[:2]) != (n_heads, n_tiles) or tiles.idx.shape[2] % slots or \
            tuple(tiles.order.shape) != (n_heads * n_tiles,) or \
            backward and tuple(tiles.members.shape) != (n_heads, n_tiles, slots):
        raise ValueError(f"{name}: tile tables do not fit {n_heads} heads, t={t}, "
                         f"block {block}: " + ", ".join(f"{k} {tuple(x.shape)}"
                                                       for k, x in tiles._asdict().items()))
    if any(x.dtype != torch.int32 for x in tiles):
        raise TypeError(f"{name}: tile tables must be int32")
    if any(x.device != q3.device for x in tiles):
        raise ValueError(f"{name}: tile tables must be on {q3.device}")
    seen = _TILES_MATCHED.get(tiles.idx)
    if seen is not None and seen[0] is idx and seen[1] is cnt:
        return
    walks = _bwd_tiles_walk_table if backward else _tiles_walk_table
    if not walks(tiles, idx, cnt, block):
        table = "transposed" if backward else "forward"
        raise ValueError(f"{name}: the tile tables do not walk the layout of the {table} "
                         f"table (build both from one layout)")
    _TILES_MATCHED[tiles.idx] = (idx, cnt)


def block_sparse_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                     fwd_idx: torch.Tensor, fwd_cnt: torch.Tensor, block: int,
                     softmax_scale: Optional[float] = None, causal: bool = False,
                     n_heads: int = 1, tiles: Optional[TileTables] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q3/k3/v3 ``(b*h, t, d)`` → ``(o (b*h, t, d) in q's dtype, lse (b*h, t)
    f32)`` over the active blocks of the forward table. The kernel
    ``csrc/block_sparse_fwd.cu`` for CUDA tensors, :func:`block_sparse_fwd_plain`
    for CPU tensors. The kernel's float32 path walks the forward table; its
    bf16/fp16 path walks ``tiles`` (:func:`kernel_tile_tables` of the same
    layout; required there). Tiles given on either device must walk the
    forward table's layout. The kernel's output has no autograd history, so
    CUDA inputs that require grad are refused while grad mode is on."""
    _check("block_sparse_fwd", (q3, k3, v3), fwd_idx, fwd_cnt, block, n_heads)
    if tiles is not None:
        _check_tiles("block_sparse_fwd", tiles, q3, fwd_idx, fwd_cnt, block, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return block_sparse_fwd_plain(q3, k3, v3, fwd_idx, fwd_cnt, block, scale, causal,
                                      n_heads)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q3, k3, v3)):
        raise ValueError("block_sparse_fwd's kernel output carries no gradient: under "
                         "autograd call block_sparse_attention (BlockSparseAttnFunction)")
    _check_cuda("block_sparse_fwd", (q3, k3, v3, fwd_idx, fwd_cnt), block)
    tile_ptrs, max_slots = (None, None, None), 0
    if q3.dtype != torch.float32:
        if tiles is None:
            raise ValueError("block_sparse_fwd's bf16/fp16 kernel walks tile tables: pass "
                             "tiles=kernel_tile_tables(layout, block, q3.device)")
        _check_cuda("block_sparse_fwd", (q3, *tiles), block)
        tile_ptrs, max_slots = tuple(x.data_ptr() for x in tiles), tiles.idx.shape[2]
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    BLOCK_SPARSE_FWD.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), fwd_idx.data_ptr(),
                            fwd_cnt.data_ptr(), *tile_ptrs, o.data_ptr(), lse.data_ptr(), bh,
                            t, d, n_heads, block, fwd_idx.shape[2], max_slots, scale,
                            int(causal), DTYPE_CODES[q3.dtype], _stream(q3))
    return o, lse


def _check_rows(name, q3, lse, delta) -> None:
    rows = tuple(q3.shape[:2])
    if tuple(lse.shape) != rows or tuple(delta.shape) != rows:
        raise ValueError(f"{name}: lse and delta must be {rows}, got {tuple(lse.shape)}, "
                         f"{tuple(delta.shape)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32, got {lse.dtype}, "
                        f"{delta.dtype}")


def block_sparse_bwd_dq(q3, k3, v3, do3, lse, delta, fwd_idx, fwd_cnt, block: int,
                        softmax_scale: Optional[float] = None, causal: bool = False,
                        n_heads: int = 1, tiles: Optional[TileTables] = None) -> torch.Tensor:
    """dq in q's dtype over the forward table: the kernel
    ``csrc/block_sparse_bwd_dq.cu`` for CUDA tensors,
    :func:`block_sparse_bwd_dq_plain` for CPU tensors. ``delta`` ``(b*h, t)``
    f32 is ``rowsum(do * o)``. The kernel's float32 path walks the forward
    table; its bf16/fp16 path walks ``tiles``, the forward kernel's
    (:func:`kernel_tile_tables` of the same layout; required there). Tiles
    given on either device must walk the forward table's layout."""
    name = "block_sparse_bwd_dq"
    _check(name, (q3, k3, v3, do3), fwd_idx, fwd_cnt, block, n_heads)
    _check_rows(name, q3, lse, delta)
    if tiles is not None:
        _check_tiles(name, tiles, q3, fwd_idx, fwd_cnt, block, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return block_sparse_bwd_dq_plain(q3, k3, v3, do3, lse, delta, fwd_idx, fwd_cnt, block,
                                         scale, causal, n_heads)
    _check_cuda(name, (q3, k3, v3, do3, lse, delta, fwd_idx, fwd_cnt), block)
    tile_ptrs, max_slots = (None,) * 3, 0
    if q3.dtype != torch.float32:
        if tiles is None:
            raise ValueError(f"{name}'s bf16/fp16 kernel walks tile tables: pass tiles="
                             f"kernel_tile_tables(layout, block, q3.device)")
        _check_cuda(name, (q3, *tiles), block)
        tile_ptrs, max_slots = tuple(x.data_ptr() for x in tiles), tiles.idx.shape[2]
    bh, t, d = q3.shape
    dq = torch.empty_like(q3)
    BLOCK_SPARSE_BWD_DQ.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), fwd_idx.data_ptr(),
                               fwd_cnt.data_ptr(), *tile_ptrs, dq.data_ptr(), bh, t, d,
                               n_heads, block, fwd_idx.shape[2], max_slots, scale, int(causal),
                               DTYPE_CODES[q3.dtype], _stream(q3))
    return dq


def block_sparse_bwd_dkv(q3, k3, v3, do3, lse, delta, bwd_idx, bwd_cnt, block: int,
                         softmax_scale: Optional[float] = None, causal: bool = False,
                         n_heads: int = 1, tiles: Optional[BwdTileTables] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in k's and v's dtype over the transposed table: the kernel
    ``csrc/block_sparse_bwd_dkv.cu`` for CUDA tensors (no atomics),
    :func:`block_sparse_bwd_dkv_plain` for CPU tensors. The kernel's float32
    path walks the transposed table; its bf16/fp16 path walks ``tiles``
    (:func:`kernel_tile_tables` of the same layout with ``backward=True``;
    required there). Tiles given on either device must walk the transposed
    table's layout."""
    name = "block_sparse_bwd_dkv"
    _check(name, (q3, k3, v3, do3), bwd_idx, bwd_cnt, block, n_heads)
    _check_rows(name, q3, lse, delta)
    if tiles is not None:
        _check_tiles(name, tiles, q3, bwd_idx, bwd_cnt, block, n_heads)
    scale = _scale(q3, softmax_scale)
    if q3.device.type == "cpu":
        return block_sparse_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, bwd_idx, bwd_cnt,
                                          block, scale, causal, n_heads)
    _check_cuda(name, (q3, k3, v3, do3, lse, delta, bwd_idx, bwd_cnt), block)
    tile_ptrs, max_slots = (None,) * 4, 0
    if q3.dtype != torch.float32:
        if tiles is None:
            raise ValueError(f"{name}'s bf16/fp16 kernel walks tile tables: pass tiles="
                             f"kernel_tile_tables(layout, block, q3.device, backward=True)")
        _check_cuda(name, (q3, *tiles), block)
        tile_ptrs, max_slots = tuple(x.data_ptr() for x in tiles), tiles.idx.shape[2]
    bh, t, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    BLOCK_SPARSE_BWD_DKV.launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), bwd_idx.data_ptr(),
                                bwd_cnt.data_ptr(), *tile_ptrs, dk.data_ptr(), dv.data_ptr(),
                                bh, t, d, n_heads, block, bwd_idx.shape[2], max_slots, scale,
                                int(causal), DTYPE_CODES[q3.dtype], _stream(q3))
    return dk, dv


def block_sparse_bwd(q3, k3, v3, o3, lse, do3, tables: Dict[str, torch.Tensor], block: int,
                     softmax_scale: Optional[float] = None, causal: bool = False,
                     n_heads: int = 1, tiles: Optional[TileTables] = None,
                     bwd_tiles: Optional[BwdTileTables] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of :func:`block_sparse_fwd` for the output
    gradient ``do3``, from the forward's ``o3`` and f32 ``lse``. ``delta =
    rowsum(do * o)`` is formed here in f32, outside the kernels, as the JAX
    package forms it; each kernel then recomputes p from ``lse``. ``tiles``
    (the forward kernel's) go to :func:`block_sparse_bwd_dq`, ``bwd_tiles``
    to :func:`block_sparse_bwd_dkv`."""
    if o3.shape != q3.shape:
        raise ValueError(f"o must be {tuple(q3.shape)}, got {tuple(o3.shape)}")
    delta = (do3.float() * o3.float()).sum(-1)
    dq = block_sparse_bwd_dq(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                             tables["fwd_cnt"], block, softmax_scale, causal, n_heads,
                             tiles=tiles)
    dk, dv = block_sparse_bwd_dkv(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                  tables["bwd_cnt"], block, softmax_scale, causal, n_heads,
                                  tiles=bwd_tiles)
    return dq, dk, dv


# ------------------------------------------------------------------ plain versions
def _masked_scores(q3, k3, idx, cnt, block, scale, causal, n_heads, transposed=False):
    """f32 scores ``(b, H, t, t)`` as the kernels form them (scaled, then the
    -1e30 causal mask), and the walked entries ``(H, t, t)``: those in the
    table's active blocks."""
    bh, t, _ = q3.shape
    s = torch.einsum("ntd,nsd->nts", q3.float(), k3.float()) * scale
    if causal:
        rows = torch.arange(t, device=q3.device)[:, None]
        cols = torch.arange(t, device=q3.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    layout = table_layout(idx, cnt)
    if transposed:
        layout = layout.transpose(1, 2)
    walked = layout.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return s.view(bh // n_heads, n_heads, t, t), walked


def block_sparse_fwd_plain(q3, k3, v3, fwd_idx, fwd_cnt, block: int, scale: float,
                           causal: bool, n_heads: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain tensor code, dense-masked: over
    the walked entries, m = max(-1e30, max s), p = exp(s - m), l = sum p, o =
    (p v) / l (l 0 → o 0), lse = m + log l (l 0 → -1e30); f32 throughout, o
    rounded to q's dtype once."""
    bh, t, d = q3.shape
    s, walked = _masked_scores(q3, k3, fwd_idx, fwd_cnt, block, scale, causal, n_heads)
    m = s.masked_fill(~walked, float("-inf")).amax(-1).clamp_min(NEG_INF)
    p = torch.exp(s - m[..., None]).masked_fill(~walked, 0.0)
    l = p.sum(-1)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("nts,nsd->ntd", p.view(bh, t, t), v3.float()) / l_safe.view(bh, t, 1)
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.full_like(m, NEG_INF))
    return o.to(q3.dtype), lse.view(bh, t)


def _probs_and_ds(q3, k3, v3, do3, lse, delta, idx, cnt, block, scale, causal, n_heads,
                  transposed):
    """The backward kernels' recompute, f32 ``(b*h, t, t)``: p = exp(s - lse)
    on the walked entries (1 on a row whose walked entries are all masked,
    whose lse is -1e30), ds = p (dp - delta) scale."""
    bh, t, _ = q3.shape
    s, walked = _masked_scores(q3, k3, idx, cnt, block, scale, causal, n_heads, transposed)
    p = torch.exp(s - lse.view(s.shape[:3])[..., None]).masked_fill(~walked, 0.0)
    p = p.view(bh, t, t)
    dp = torch.einsum("ntd,nsd->nts", do3.float(), v3.float())
    ds = p * (dp - delta.float()[..., None]) * scale
    return p, ds


def block_sparse_bwd_dq_plain(q3, k3, v3, do3, lse, delta, fwd_idx, fwd_cnt, block: int,
                              scale: float, causal: bool, n_heads: int = 1) -> torch.Tensor:
    """The dq kernel's function in plain tensor code: dq = ds k, f32 sums."""
    _, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, fwd_idx, fwd_cnt, block, scale,
                          causal, n_heads, transposed=False)
    return torch.einsum("nts,nsd->ntd", ds, k3.float()).to(q3.dtype)


def block_sparse_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, bwd_idx, bwd_cnt, block: int,
                               scale: float, causal: bool, n_heads: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain tensor code, from the transposed
    table: dk = ds^T q, dv = p^T do, f32 sums."""
    p, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, bwd_idx, bwd_cnt, block, scale,
                          causal, n_heads, transposed=True)
    dk = torch.einsum("nts,ntd->nsd", ds, q3.float()).to(k3.dtype)
    dv = torch.einsum("nts,ntd->nsd", p, do3.float()).to(v3.dtype)
    return dk, dv


# ------------------------------------------------------------------ autograd
class BlockSparseAttnFunction(torch.autograd.Function):
    """``o = block-sparse attention(q3, k3, v3)`` through :func:`block_sparse_fwd`,
    differentiated by :func:`block_sparse_bwd`; the port of the ``_bs_core``
    custom VJP. It saves q, k, v, o, the f32 lse and the four tables, and
    keeps both kinds of tile tables for the backward (the forward's for dq,
    the transposed layout's for dk/dv); the tables and the tile tables get
    no gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, fwd_idx, fwd_cnt, bwd_idx, bwd_cnt, block, softmax_scale,
                causal, n_heads, tiles, bwd_tiles):
        o3, lse = block_sparse_fwd(q3, k3, v3, fwd_idx, fwd_cnt, block, softmax_scale, causal,
                                   n_heads, tiles=tiles)
        ctx.save_for_backward(q3, k3, v3, o3, lse, fwd_idx, fwd_cnt, bwd_idx, bwd_cnt)
        ctx.args = (block, softmax_scale, causal, n_heads, tiles, bwd_tiles)
        return o3

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o3, lse, *tables = ctx.saved_tensors
        block, softmax_scale, causal, n_heads, tiles, bwd_tiles = ctx.args
        dq, dk, dv = block_sparse_bwd(q3, k3, v3, o3, lse, do3.contiguous(),
                                      dict(zip(TABLE_NAMES, tables)), block, softmax_scale,
                                      causal, n_heads, tiles=tiles, bwd_tiles=bwd_tiles)
        return (dq, dk, dv) + (None,) * 10


# ------------------------------------------------------------------ public ops
def _attend(q, k, v, tables: Dict[str, torch.Tensor], tiles: Optional[TileTables],
            bwd_tiles: Optional[BwdTileTables], block: int, causal: bool,
            softmax_scale: Optional[float]) -> torch.Tensor:
    b, t, h, d = q.shape

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o3 = BlockSparseAttnFunction.apply(to3(q), to3(k), to3(v),
                                       *(tables[n] for n in TABLE_NAMES), block,
                                       softmax_scale, causal, h, tiles, bwd_tiles)
    return o3.reshape(b, h, t, d).transpose(1, 2)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout: np.ndarray, block: int, causal: bool = False,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v ``(b, t, h, d)`` with a (h, nb, nb) block ``layout`` → ``(b, t, h, d)``,
    through :class:`BlockSparseAttnFunction`, so it is differentiable on the card
    as on the CPU. ``causal`` applies the elementwise triangle on top of the
    block mask (use with unidirectional layouts). Rows whose layout is empty
    produce zeros. The tables (and the tile tables of the bf16/fp16 kernels:
    the forward's, which dq walks too, and dk/dv's) are built on the host and
    copied to q's device on every call; :func:`make_sparse_attention_impl`
    caches them."""
    b, t, h, d = q.shape
    if not (k.shape == q.shape and v.shape == q.shape):
        raise AssertionError("self-attention only")
    layout = np.asarray(layout)
    if not (layout.shape[0] == h):
        raise AssertionError((layout.shape, h))
    if not (layout.shape[1] * block == t):
        raise AssertionError(f"layout covers {layout.shape[1] * block} positions, inputs "
                             f"have {t}")
    return _attend(q, k, v, device_tables(build_tables(layout), q.device),
                   kernel_tile_tables(layout, block, q.device),
                   kernel_tile_tables(layout, block, q.device, backward=True), block, causal,
                   softmax_scale)


def _layout_mask(layout: np.ndarray, block: int, device) -> torch.Tensor:
    """``(1, H, t, t)`` bool: the layout expanded to a dense mask."""
    return torch.from_numpy(layout_to_dense_mask(np.asarray(layout), block)).to(device)[None]


def block_sparse_attention_reference(q, k, v, layout, block, causal=False,
                                     softmax_scale=None):
    """Dense-masked ground truth: the port's ``reference_attention`` with the
    layout's dense mask (tests; differs from the kernels on rows with no
    valid key, see the module docstring)."""
    from ..transformer.attention import reference_attention
    return reference_attention(q, k, v, causal=causal,
                               mask=_layout_mask(layout, block, q.device),
                               softmax_scale=softmax_scale)


def make_sparse_attention_impl(config: SparsityConfig):
    """Bind a :class:`SparsityConfig` into an attention impl of the
    ``get_attention_impl`` signature (the ``SparseSelfAttention`` role): the
    layout is built and cached per sequence length, and its tables with the
    bf16/fp16 kernels' tile tables (forward and dq; dk/dv) as device tensors,
    one entry per (length, device), so a training step builds and copies no
    table. A user ``mask``, attention dropout (``dropout_rate > 0``) or a q
    shorter than k keeps the sparsity pattern on the masked dense path
    (``reference_attention`` with the layout's dense mask, and the dropout),
    as the JAX impl does (``block_sparse.py:345-361``); no kernel launches
    there."""
    layouts: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, torch.device], Tuple[Dict[str, torch.Tensor], Optional[TileTables],
                                                 Optional[BwdTileTables]]] = {}

    def layout_for(s: int) -> np.ndarray:
        if s not in layouts:
            layouts[s] = config.make_layout(s)
        return layouts[s]

    def impl(q, k, v, causal=True, mask=None, softmax_scale=None, dropout_rate=0.0,
             dropout_rng=None):
        from ..transformer.attention import reference_attention
        uni = getattr(config, "attention", "bidirectional") == "unidirectional"
        if mask is not None or dropout_rate > 0.0 or q.shape[1] != k.shape[1]:
            # features the kernels do not cover: keep the sparsity pattern on the
            # masked dense path (dense attention would change the architecture)
            t, s = q.shape[1], k.shape[1]
            lmask = _layout_mask(layout_for(s), config.block, q.device)
            lmask = lmask[:, :, -t:, :]  # decode: q covers the cache tail
            if mask is not None:
                user = mask[:, None, None, :] if mask.ndim == 2 else mask
                lmask = torch.logical_and(lmask, user.bool())
            return reference_attention(q, k, v, causal=causal or uni, mask=lmask,
                                       softmax_scale=softmax_scale, dropout_rate=dropout_rate,
                                       dropout_rng=dropout_rng)
        t = q.shape[1]
        key = (t, q.device)
        if key not in tables:
            layout = layout_for(t)
            tables[key] = (device_tables(build_tables(layout), q.device),
                           kernel_tile_tables(layout, config.block, q.device),
                           kernel_tile_tables(layout, config.block, q.device, backward=True))
        return _attend(q, k, v, *tables[key], config.block, causal or uni, softmax_scale)

    return impl
