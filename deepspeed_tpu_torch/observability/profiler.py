"""The device-profiler capture hook.

Counterpart of ``deepspeed_tpu/observability/profiler.py``, ``tick`` only: the
serving executor calls :func:`tick` once per unit of work (a prefill, a decode
chunk), where the JAX package's on-demand capture counts the units it traces.
Capture through ``torch.profiler`` is not ported yet (ROADMAP.md queue 1 item
9), so no capture is ever configured and a tick does nothing.
"""


def tick(kind: str = "step") -> None:
    """Hot-path hook: one unit of work of ``kind`` completed."""
