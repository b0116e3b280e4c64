"""Strict dataclass configs built from dicts: the port's stand-in for the JAX
package's pydantic ``ConfigModel`` (``deepspeed_tpu/config/config_utils.py``)."""

import dataclasses
from typing import Any


def from_dict(cls, data: Any, where: str):
    """``cls(**data)`` for a dict ``data`` (an instance of ``cls`` passes as it
    is). A key ``cls`` does not have raises ``ValueError`` naming the known
    ones."""
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise TypeError(f"{where} must be a dict, got {type(data).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"unknown {where} key(s) {unknown}; known: {sorted(known)}")
    return cls(**data)


def is_off(value: Any) -> bool:
    """Whether a config value leaves its feature at the default (off): None,
    False, 0, an empty container, or a block with ``"enabled": false``."""
    if isinstance(value, dict) and value:
        return value.get("enabled", True) is False
    return not value
