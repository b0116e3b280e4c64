"""Grouped symmetric int8/int4 weight quantization, in torch.

Counterpart of ``deepspeed_tpu/ops/quantizer/quant.py``, with the same
results bit for bit: weights ``(..., k, n)`` are quantized per group of ``g``
rows along the contraction dimension ``k``, with one f32 scale per group per
output column; ``bits=4`` clips to [-7, 7] and packs two nibbles per int8 byte.

The int4 layout is per-group split-half: within each scale group of ``g``
rows, byte row ``j`` (``j < g/2``) holds logical row ``j`` in its low nibble
and row ``j + g/2`` in its high nibble. The nibble arithmetic runs in int32
(a left shift of a torch int8 overflows); a low nibble is sign-extended as
``((b & 0xF) ^ 8) - 8``, a high one as ``b >> 4`` on the sign-extended byte.

Engine quant nodes are dicts under the JAX package's key names
(``__int8_q__``/``__int8_scale__``, ``__int4_q__``/``__int4_scale__``): the
payload in ``(k, n)`` layout (``(k/2, n)`` packed for int4) and the f32 scales.
"""

import logging
from collections.abc import Mapping
from typing import Optional, Tuple

import torch

from ...utils.logging import log_dist

DEFAULT_GROUP = 128


def _group_size(k: int, group_size: int, *, warn_for: Optional[str] = None) -> int:
    """The largest group ``<= min(group_size, k)`` reached by halving that
    divides ``k`` (1 at worst); warns, naming ``warn_for``, when it had to
    shrink."""
    g = min(group_size, k)
    while k % g:
        g //= 2
    g = max(g, 1)
    if warn_for is not None and g < min(group_size, k):
        # a degraded group bloats the scale tensor (4/g bytes per element)
        # and at g == 1 erases the storage win: say so
        log_dist(f"quantize[{warn_for}]: requested group {group_size} does not "
                 f"divide k={k}; effective group degraded to {g} "
                 f"(scale overhead {4.0 / g:.3f} B/elem)", ranks=[0], level=logging.WARNING)
    return g


def quantize_grouped(w, group_size: int = DEFAULT_GROUP, bits: int = 8,
                     warn_for: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w ``(..., k, n)`` → (q int8 ``(..., k, n)``, scales f32 ``(..., k//g, n)``).

    Symmetric and zero-point-free: ``scale = amax / qmax`` per group and
    column (1 where the group is all zero), ``q = clip(round(w / scale))``
    with round-half-to-even, in f32. ``bits=4`` clips to [-7, 7] in an int8
    carrier (see :func:`pack_int4` for the storage form)."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_grouped: bits={bits} not in (8, 4)")
    w = torch.as_tensor(w)
    k, n = w.shape[-2], w.shape[-1]
    g = _group_size(k, group_size, warn_for=warn_for)
    lead = tuple(w.shape[:-2])
    qmax = 127.0 if bits == 8 else 7.0
    wg = w.reshape(*lead, k // g, g, n).float()
    amax = wg.abs().amax(dim=-2, keepdim=True)                  # (..., k//g, 1, n)
    # qmax as a tensor on w's device: CUDA divides by a CPU scalar as a
    # product with its reciprocal, one bit off the CPU's (and JAX's) quotient
    qmax_t = torch.tensor(qmax, dtype=torch.float32, device=w.device)
    scale = torch.where(amax > 0, amax / qmax_t, torch.ones_like(amax))
    q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int8)
    return q.reshape(*lead, k, n), scale[..., 0, :].contiguous()


def dequantize_grouped(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_grouped` (unpacked int8 carrier) → f32."""
    k, n = q.shape[-2], q.shape[-1]
    groups = scales.shape[-2]
    lead = tuple(q.shape[:-2])
    wg = q.reshape(*lead, groups, k // groups, n).float()
    return (wg * scales.float()[..., :, None, :]).reshape(*lead, k, n)


def pack_int4(q: torch.Tensor, groups: int) -> torch.Tensor:
    """int4 values (int8 carrier in [-7, 7], ``(..., k, n)``) → ``(..., k//2, n)``
    int8, two nibbles per byte in the per-group split-half layout. The group
    size ``k // groups`` must be an even integer."""
    q = torch.as_tensor(q)
    k, n = q.shape[-2], q.shape[-1]
    g = k // groups
    if k % groups or g % 2:
        raise ValueError(f"pack_int4: group size k/groups = {k}/{groups} must be an even "
                         "integer (two nibbles pack across each group's halves)")
    lead = tuple(q.shape[:-2])
    qg = q.reshape(*lead, groups, g, n).to(torch.int32)
    lo, hi = qg[..., : g // 2, :], qg[..., g // 2:, :]
    packed = ((hi << 4) | (lo & 0xF)).to(torch.int8)
    return packed.reshape(*lead, k // 2, n)


def unpack_int4(packed: torch.Tensor, groups: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``(..., k//2, n)`` int8 → ``(..., k, n)``
    int8 in [-7, 7] (sign-extended nibbles)."""
    packed = torch.as_tensor(packed)
    k2, n = packed.shape[-2], packed.shape[-1]
    k = 2 * k2
    lead = tuple(packed.shape[:-2])
    pg = packed.reshape(*lead, groups, k // groups // 2, n).to(torch.int32)
    lo = ((pg & 0xF) ^ 8) - 8
    hi = pg >> 4
    return torch.cat([lo, hi], dim=-2).to(torch.int8).reshape(*lead, k, n)


# --------------------------------------------------------- engine node helpers
INT8_Q = "__int8_q__"
INT8_SCALE = "__int8_scale__"
INT4_Q = "__int4_q__"
INT4_SCALE = "__int4_scale__"


def make_quant_node(q, scales, bits: int) -> dict:
    if bits == 8:
        return {INT8_Q: q, INT8_SCALE: scales}
    return {INT4_Q: q, INT4_SCALE: scales}


def is_quant_node(node) -> bool:
    return isinstance(node, Mapping) and (INT8_Q in node or INT4_Q in node)


def node_bits(node) -> int:
    return 8 if INT8_Q in node else 4


def node_qs(node) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantized payload, scales) of a quant node."""
    if INT8_Q in node:
        return node[INT8_Q], node[INT8_SCALE]
    return node[INT4_Q], node[INT4_SCALE]


def node_logical_shape(node) -> Tuple[int, ...]:
    """The ``(..., k, n)`` shape of the weight a quant node stands in for."""
    q, _ = node_qs(node)
    if node_bits(node) == 4:
        return tuple(q.shape[:-2]) + (2 * q.shape[-2], q.shape[-1])
    return tuple(q.shape)


def dequantize_node(node) -> torch.Tensor:
    """A quant node collapsed to the f32 weight."""
    q, scales = node_qs(node)
    if node_bits(node) == 4:
        q = unpack_int4(q, scales.shape[-2])
    return dequantize_grouped(q, scales)


def quantize_with_audit(w, *, bits: int, group_size: int, threshold: float, name: str):
    """Quantize one matrix ``(..., k, n)`` with a relative-error audit.

    Returns ``(node_or_None, info)``: the quant node (int4 payload packed),
    or None where the matrix must stay fp, and ``info`` = ``{name, decision,
    reason, bits, group_requested, group_effective, rel_err}``. Decisions:
    ``quantized`` (error at most ``threshold``); ``excluded`` for an
    outlier-heavy matrix (error above it) or for ``bits=4`` with an odd
    effective group (split-half packing needs an even one; decided before any
    quantization work). The error masks each group's scale-setting peak out
    of both the error and the reference, since the peak quantizes exactly
    while the rest of its group is crushed."""
    w = torch.as_tensor(w).float()
    k = w.shape[-2]
    g = _group_size(k, group_size, warn_for=name)
    info = {"name": name, "bits": bits, "group_requested": group_size, "group_effective": g}
    if bits == 4 and g % 2:
        info.update(rel_err=None, decision="excluded",
                    reason=f"effective group {g} is odd — int4 split-half packing needs an "
                    "even group; kept fp")
        return None, info
    q, s = quantize_grouped(w, group_size, bits=bits)
    lead = tuple(w.shape[:-2])
    n = w.shape[-1]
    wg = w.reshape(*lead, k // g, g, n)
    eg = (dequantize_grouped(q, s) - w).reshape(*lead, k // g, g, n)
    keep = wg.abs() < wg.abs().amax(dim=-2, keepdim=True)
    err = torch.linalg.vector_norm((eg * keep).reshape(-1))
    ref = torch.linalg.vector_norm((wg * keep).reshape(-1))
    rel = float(err) / max(float(ref), 1e-12)
    info["rel_err"] = rel
    if rel > threshold:
        info.update(decision="excluded",
                    reason=f"rel_err {rel:.4f} > outlier_threshold {threshold:.4f}")
        return None, info
    if bits == 4:
        q = pack_int4(q, s.shape[-2])
    info.update(decision="quantized", reason="")
    return make_quant_node(q, s.float(), bits), info


def validate_quant_config(quant_cfg) -> None:
    """The legacy ``quant`` block (and ``dtype="int8"``) means 8-bit grouped
    quantization only; another width raises rather than silently serving
    8-bit. 4-bit lives behind the ``weight_quant`` block."""
    bits = getattr(quant_cfg, "bits", 8)
    if getattr(quant_cfg, "enabled", False) and bits != 8:
        raise NotImplementedError(
            f"quant.bits={bits} requested but the legacy quant block is 8-bit grouped only "
            "(reference GroupQuantizer is 8-bit too) — use the weight_quant config block "
            "for int4")
