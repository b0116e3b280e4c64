"""Checkpoint topology descriptors and rank-file reshape maps.

A copy of ``deepspeed_tpu/checkpoint/reshape.py`` (pure Python there too),
itself a re-design of ``deepspeed/checkpoint/reshape_meg_2d.py`` and
``reshape_3d_utils.py``: a (pp, tp) cell of the new topology maps to the list
of old rank indices whose shards it must merge, with the dp dimension
partitioned on top, one dict comprehension per transform. Only degree
contraction is supported (e.g. tp 4 -> 2), as in the reference. The maps drive
the reading of reference checkpoint files
(:class:`~.deepspeed_checkpoint.DeepSpeedCheckpoint`); merged tensors are
always full.
"""

import dataclasses
import os
import re
from typing import Dict, List, Tuple

from .constants import (BF16_ZERO_FILE_PREFIX, FP16_ZERO_FILE_PREFIX,
                        LAYER_FILE_PREFIX, MODEL_FILE_PREFIX, ZERO_FILE_PREFIX)


def _partition(lst: List, n: int) -> List[List]:
    if not (len(lst) % n == 0):
        raise AssertionError(f"cannot partition {len(lst)} items into {n}")
    sz = len(lst) // n
    return [lst[i * sz:(i + 1) * sz] for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Model3DDescriptor:
    """Source topology of a reference checkpoint (``model_3d_desc``)."""
    pp_degree: int
    tp_degree: int
    dp_degree: int

    def world_size(self) -> int:
        return max(self.pp_degree, 1) * self.tp_degree * self.dp_degree

    def can_reshape(self, other: "Model3DDescriptor") -> Tuple[bool, List[str]]:
        errs = [f"Expansion reshape not supported - {dim}: {old} ---> {new}"
                for dim, old, new in [("PP", self.pp_degree, other.pp_degree),
                                      ("TP", self.tp_degree, other.tp_degree),
                                      ("DP", self.dp_degree, other.dp_degree)]
                if new > old]
        return not errs, errs


def reshape_meg_2d_parallel(old_pp: int, old_tp: int, new_pp: int, new_tp: int
                            ) -> Dict[Tuple[int, int], List[int]]:
    """(new_pp_idx, new_tp_idx) → ordered old 2D rank indices to merge.

    Old rank layout is row-major (pp major, tp minor), as Megatron numbers them;
    contracting tp by r merges r consecutive tp ranks, contracting pp by r merges r
    consecutive pp rows — the same grouping ``reshape_meg_2d.py`` produces.
    """
    if not (old_pp % new_pp == 0 and old_tp % new_tp == 0):
        raise AssertionError(f"degrees must contract evenly: pp {old_pp}->{new_pp}, tp {old_tp}->{new_tp}")
    # start from the identity map, contract tp, then pp
    cells = {(p, t): [p * old_tp + t] for p in range(old_pp) for t in range(old_tp)}
    if new_tp != old_tp:
        cells = {(p, tj): sum((cells[(p, t)] for t in row), [])
                 for p in range(old_pp)
                 for tj, row in enumerate(_partition(list(range(old_tp)), new_tp))}
    if new_pp != old_pp:
        cells = {(pj, t): sum((cells[(p, t)] for p in col), [])
                 for t in range(new_tp)
                 for pj, col in enumerate(_partition(list(range(old_pp)), new_pp))}
    return cells


def reshape_3d(src: Model3DDescriptor, dst: Model3DDescriptor
               ) -> List[Dict[Tuple[int, int], List[int]]]:
    """Per-new-dp-index 2D maps of GLOBAL old rank indices (``model_3d_desc.reshape``).

    Old global rank = dp_index * (pp*tp) + 2d_index (dp outermost, matching the
    reference's ``flatten_dp_dimension``)."""
    ok, errs = src.can_reshape(dst)
    if not (ok):
        raise AssertionError(",".join(errs))
    base = reshape_meg_2d_parallel(src.pp_degree, src.tp_degree,
                                   dst.pp_degree, dst.tp_degree)
    plane = src.pp_degree * src.tp_degree
    out = []
    for dp_group in _partition(list(range(src.dp_degree)), dst.dp_degree):
        out.append({cell: [dp * plane + idx for dp in dp_group for idx in idxs]
                    for cell, idxs in base.items()})
    return out


# --------------------------------------------------------------------- folder scan
def _natural_key(path: str):
    """Sort key treating digit runs numerically: zero_pp_rank_10 sorts AFTER
    zero_pp_rank_9 (lexical order would scramble dp ranks >= 10 and silently
    corrupt partition concatenation — reference zero_to_fp32.py sorts the same way)."""
    return [int(tok) if tok.isdigit() else tok
            for tok in re.split(r"(\d+)", os.path.basename(path))]


def _files(dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(dir):
        out.extend(os.path.join(root, f) for f in files)
    return sorted(out, key=_natural_key)


def _with_prefix(files: List[str], prefix: str) -> List[str]:
    return sorted((f for f in files if os.path.basename(f).startswith(prefix)),
                  key=_natural_key)


def get_zero_files(dir: str) -> List[str]:
    files = _files(dir)
    for prefix in (ZERO_FILE_PREFIX, FP16_ZERO_FILE_PREFIX, BF16_ZERO_FILE_PREFIX):
        zf = _with_prefix(files, prefix)
        if zf:
            return zf
    return []


def get_model_3d_descriptor(dir: str) -> Model3DDescriptor:
    """Infer (pp, tp, dp) from the checkpoint's file census — same inference as
    reference ``get_model_3d_descriptor`` (layer files ⇒ pipeline-style layout)."""
    files = _files(dir)
    zero_files = get_zero_files(dir)
    mp_files = _with_prefix(files, MODEL_FILE_PREFIX)
    # tp degree = number of model shards of the first layer file, if layers exist
    layer_ids = sorted({m.group(1) for f in files
                        for m in [re.match(rf"{LAYER_FILE_PREFIX}(\d+)-model_",
                                           os.path.basename(f))] if m})
    if layer_ids:
        tp = len([f for f in files if os.path.basename(f).startswith(
            f"{LAYER_FILE_PREFIX}{layer_ids[0]}-model_")])
        pp = len(mp_files) // max(tp, 1)
        dp = max(1, len(zero_files) // max(pp * tp, 1))
        return Model3DDescriptor(pp_degree=pp, tp_degree=tp, dp_degree=dp)
    tp = len(mp_files)
    dp = max(1, len(zero_files) // max(tp, 1))
    return Model3DDescriptor(pp_degree=0, tp_degree=tp, dp_degree=dp)
