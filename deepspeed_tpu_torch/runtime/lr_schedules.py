"""Learning-rate schedules.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure Python there too):
``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR`` and
``get_lr_scheduler``, the behavioural equivalents of DeepSpeed's
``deepspeed/runtime/lr_schedules.py``. Each schedule is a host-side object with
a ``step()/get_lr()/state_dict()`` surface; the engine reads the learning rate
as a Python float each step and hands it to the optimizer, so stepping a
schedule never waits on the card.
"""

import math
from typing import List, Optional, Union

from ..utils.logging import logger

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


class _Schedule:
    """Common step/state plumbing (mirrors torch scheduler surface the reference exposes)."""

    def __init__(self, last_batch_iteration: int = -1):
        self.last_batch_iteration = last_batch_iteration
        self._last_lr: List[float] = [0.0]

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()

    def get_last_lr(self) -> List[float]:
        return list(self._last_lr)

    @property
    def lr(self) -> float:
        if self.last_batch_iteration < 0:
            self.last_batch_iteration = 0
            out = self.get_lr()[0]
            self.last_batch_iteration = -1
            return out
        return self.get_lr()[0]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        """Restore the position; the last lr follows it, so a resumed engine
        reads the saved schedule's lr without stepping it again (the JAX
        package's keeps its stale last lr here)."""
        self.last_batch_iteration = sd["last_batch_iteration"]
        if self.last_batch_iteration >= 0:
            self._last_lr = self.get_lr()


class LRRangeTest(_Schedule):
    """Reference ``lr_schedules.py:308`` — linear/continuous LR sweep for range tests."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: Union[float, List[float]] = 1e-3,
                 lr_range_test_step_size: int = 2000, lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False, last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        self.min_lr = (lr_range_test_min_lr if isinstance(lr_range_test_min_lr, (int, float))
                       else lr_range_test_min_lr[0])
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if self.staircase:
            interval = float(it // self.step_size)
        else:
            interval = it / self.step_size
        return [self.min_lr * (1 + self.step_rate * interval)]


class OneCycle(_Schedule):
    """Reference ``lr_schedules.py:415`` — 1cycle policy (cycle up, down, then decay)."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 1e-4, cycle_max_lr: float = 1e-3,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = (cycle_second_step_size if cycle_second_step_size is not None
                            else cycle_first_step_size)
        self.decay_step_size = decay_step_size
        self.total_cycle = self.first_size + self.second_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if it <= self.total_cycle:
            if it <= self.first_size:
                frac = it / self.first_size
                lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
            else:
                frac = (it - self.first_size) / self.second_size
                lr = self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * frac
            return [lr]
        # decay phase
        decay_steps = it - self.total_cycle
        if self.decay_step_size > 0:
            intervals = decay_steps / self.decay_step_size
        else:
            intervals = decay_steps
        return [self.cycle_min_lr / (1.0 + self.decay_lr_rate * intervals)]

    def get_mom(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if not self.cycle_momentum or it > self.total_cycle:
            return [self.cycle_min_mom]
        if it <= self.first_size:
            frac = it / self.first_size
            return [self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * frac]
        frac = (it - self.first_size) / self.second_size
        return [self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * frac]


class WarmupLR(_Schedule):
    """Reference ``lr_schedules.py:704`` — warm up then hold."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__(last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if not (warmup_type in ("log", "linear")):
            raise AssertionError('warmup_type in ("log", "linear")')
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_gamma(self, it: int) -> float:
        if it < self.warmup_num_steps:
            if self.warmup_type == "log":
                return self.inverse_log_warm_up * math.log(it + 1)
            return it / self.warmup_num_steps
        return 1.0

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        gamma = self._warmup_gamma(it)
        return [self.min_lr + (self.max_lr - self.min_lr) * gamma]


class WarmupDecayLR(WarmupLR):
    """Reference ``lr_schedules.py:800`` — warm up then linear decay to zero."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(f"total_num_steps {total_num_steps} is less than "
                           f"warmup_num_steps {warmup_num_steps}")

    def _warmup_gamma(self, it: int) -> float:
        if it < self.warmup_num_steps:
            return super()._warmup_gamma(it)
        return max(0.0, (self.total_num_steps - it) /
                   max(1, self.total_num_steps - self.warmup_num_steps))


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_scheduler(name: str, params: dict, optimizer=None) -> _Schedule:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown LR schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](optimizer=optimizer, **params)
