"""Deterministic fault injection and retry, as the serving column uses them.

Counterpart of ``deepspeed_tpu/utils/fault_injection.py`` (the part the
serving modules call): production paths declare named fault points
(``fault_point("serving.prefill")``) that cost one empty-dict check when
nothing is armed, and tests arm them with :class:`FaultSpec` through
:class:`inject`:

    with inject("serving.decode_chunk", FaultSpec(kind="io_error", max_faults=1)):
        scheduler.run()         # the first chunk raises OSError, the retry runs

Kinds: ``io_error`` raises ``spec.exc_type(spec.message)``; ``kill`` sends
SIGKILL to this process; ``delay`` sleeps ``spec.delay_s``. Probabilistic
faults draw from the registry's seeded RNG, so a failing test replays
exactly. :func:`retry_with_backoff` is the shared retry policy. The env-var
propagation to child processes and the fault-point listing belong to the
fleet (ROADMAP.md queue 1 item 9).
"""

import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Type

from .logging import logger


@dataclass
class FaultSpec:
    """One armed fault at a named site. ``after_n`` lets the first N hits pass;
    ``max_faults`` bounds how often it fires (None: every eligible hit);
    ``prob`` gates each eligible hit through the registry's seeded RNG."""
    kind: str = "io_error"              # io_error | kill | delay
    prob: float = 1.0
    after_n: int = 0
    max_faults: Optional[int] = None
    exc_type: Type[BaseException] = OSError
    message: str = "injected fault"
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in ("io_error", "kill", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             "(expected io_error | kill | delay)")


@dataclass
class _ArmedFault:
    spec: FaultSpec
    hits: int = 0
    fired: int = 0


class FaultRegistry:
    """Process-local registry of armed faults, keyed by site name."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[_ArmedFault]] = {}
        self._rng = random.Random(seed)

    def arm(self, site: str, spec: FaultSpec) -> _ArmedFault:
        armed = _ArmedFault(spec)
        with self._lock:
            self._faults.setdefault(site, []).append(armed)
        return armed

    def disarm(self, site: str, armed: _ArmedFault) -> None:
        with self._lock:
            lst = self._faults.get(site, [])
            if armed in lst:
                lst.remove(armed)
            if not lst:
                self._faults.pop(site, None)

    def check(self, site: str) -> None:
        """The fault point: decide under the lock whether an armed fault fires,
        then act outside it. Nothing to do when nothing is armed."""
        if not self._faults:
            return
        to_fire: Optional[FaultSpec] = None
        with self._lock:
            for armed in self._faults.get(site, ()):
                spec = armed.spec
                armed.hits += 1
                if armed.hits <= spec.after_n:
                    continue
                if spec.max_faults is not None and armed.fired >= spec.max_faults:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                armed.fired += 1
                to_fire = spec
                break
        if to_fire is None:
            return
        if to_fire.kind == "delay":
            time.sleep(to_fire.delay_s)
            return
        if to_fire.kind == "kill":
            logger.error(f"[fault] kill injected at {site!r}")
            os.kill(os.getpid(), signal.SIGKILL)
        logger.warning(f"[fault] {to_fire.kind} injected at {site!r}: {to_fire.message}")
        raise to_fire.exc_type(f"{to_fire.message} [site={site}]")


_REGISTRY = FaultRegistry()


def fault_point(site: str) -> None:
    """Named fault point, free when no fault is armed."""
    _REGISTRY.check(site)


class inject:
    """Arm ``spec`` at ``site`` for the scope of the context manager."""

    def __init__(self, site: str, spec: FaultSpec):
        self.site = site
        self.spec = spec
        self._armed: Optional[_ArmedFault] = None

    @property
    def fired(self) -> int:
        return self._armed.fired if self._armed is not None else 0

    def __enter__(self) -> "inject":
        self._armed = _REGISTRY.arm(self.site, self.spec)
        return self

    def __exit__(self, *exc):
        _REGISTRY.disarm(self.site, self._armed)
        return False


def retry_with_backoff(fn: Callable, retries: int = 3, base_delay: float = 0.05,
                       max_delay: float = 2.0,
                       retryable: Tuple[Type[BaseException], ...] = (OSError,),
                       sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` with up to ``retries`` retries on ``retryable`` exceptions,
    sleeping ``base_delay * 2**attempt`` (at most ``max_delay``) between
    attempts. Other exceptions propagate at once; the last retryable one
    propagates when the budget is spent."""
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            if attempt >= retries:
                raise
            delay = min(base_delay * (2 ** attempt), max_delay)
            logger.warning(f"[retry] attempt {attempt + 1}/{retries} failed "
                           f"({type(e).__name__}: {e}); retrying in {delay:.2f}s")
            sleep(delay)
            attempt += 1
