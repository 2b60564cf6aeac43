"""LR schedules: plain ``step -> float`` functions with the formulas of
``deepspeed_tpu/runtime/lr_schedules.py`` (LRRangeTest, OneCycle,
WarmupLR, WarmupDecayLR, WarmupCosineLR), built from the same JSON
"scheduler" params.  The optimizer reads its schedule at the
pre-increment update count, so step 0 uses ``schedule(0)``."""
import math
from typing import Callable

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]

Schedule = Callable[[int], float]


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval
                                       * lr_range_test_step_rate)
    return schedule


def one_cycle(cycle_min_lr: float = 1e-3, cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: int = None, **_) -> Schedule:
    second = cycle_second_step_size or cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        if step <= cycle_first_step_size:
            up = _clip(step / cycle_first_step_size, 0.0, 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
        if step <= total_cycle:
            down = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        if decay_step_size > 0 and decay_lr_rate > 0:
            return cycle_min_lr / (1.0 + math.floor(
                (step - total_cycle) / decay_step_size) * decay_lr_rate)
        return cycle_min_lr
    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    def schedule(step):
        if step >= warmup_num_steps:
            return warmup_max_lr
        frac = _clip((step + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
        # log-spaced ramp, the reference's default warmup curve
        gamma = (math.log(frac * (math.e - 1) + 1) if warmup_type == "log"
                 else frac)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma
    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def schedule(step):
        if step < warmup_num_steps:
            return warm(step)
        return warmup_max_lr * _clip(
            (total_num_steps - step)
            / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3, **_) -> Schedule:
    def schedule(step):
        if step < warmup_num_steps:
            warm = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * warm
        else:
            cos = _clip((step - warmup_num_steps)
                        / max(total_num_steps - warmup_num_steps, 1),
                        0.0, 1.0)
            ratio = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * cos))
        return warmup_max_lr * ratio
    return schedule


_FACTORIES = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


def get_lr_schedule(name: str, params: dict,
                    base_lr: float = None) -> Schedule:
    if name not in _FACTORIES:
        raise ValueError(f"unknown scheduler {name!r}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    params = dict(params)
    if base_lr is not None:
        params.setdefault("warmup_max_lr", base_lr)
        params.setdefault("cycle_max_lr", base_lr)
    return _FACTORIES[name](**params)
