"""LR schedules (counterpart of deepspeed_tpu/runtime/lr_schedules.py):
WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest, configured
through the "scheduler" config block.  Each schedule is a plain function of
an int step that returns a float; it carries no state and does no device
work."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

Schedule = Callable[[int], float]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def _warmup(step, warmup_min_lr, warmup_max_lr, warmup_num_steps,
            warmup_type):
    """Warmup ramp shared by the Warmup* schedules: linear in the step, or
    log(step + 1) / log(warmup_steps + 1)."""
    if warmup_type == WARMUP_LOG_RATE:
        frac = _clip01(math.log1p(step) / math.log(warmup_num_steps + 1))
    else:
        frac = _clip01(step / max(warmup_num_steps, 1))
    return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = WARMUP_LOG_RATE, **_) -> Schedule:
    """WarmupLR: ramp to max, then hold."""
    def sched(step):
        return float(_warmup(step, warmup_min_lr, warmup_max_lr,
                             warmup_num_steps, warmup_type))
    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = WARMUP_LOG_RATE, **_) -> Schedule:
    """WarmupDecayLR: warmup, then linear decay to 0 at total_num_steps."""
    def sched(step):
        if step < warmup_num_steps:
            return float(_warmup(step, warmup_min_lr, warmup_max_lr,
                                 warmup_num_steps, warmup_type))
        decay = _clip01((total_num_steps - step)
                        / max(total_num_steps - warmup_num_steps, 1))
        return float(warmup_max_lr * decay)
    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001,
                     warmup_type: str = WARMUP_LINEAR_RATE, **_) -> Schedule:
    """WarmupCosineLR: linear ratio warmup, then a cosine to cos_min_ratio."""
    def sched(step):
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * _clip01(
                step / max(warmup_num_steps, 1))
        else:
            progress = _clip01((step - warmup_num_steps)
                               / max(total_num_steps - warmup_num_steps, 1))
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
                1 + math.cos(math.pi * progress))
        return float(warmup_max_lr * ratio)
    return sched


def one_cycle(cycle_min_lr: float = 1e-5, cycle_max_lr: float = 1e-3,
              cycle_first_step_size: int = 1000,
              cycle_second_step_size: int = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    """OneCycle, LR part only: up, down, then an optional staircase decay."""
    second = cycle_second_step_size or cycle_first_step_size
    end = cycle_first_step_size + second

    def sched(step):
        if step < cycle_first_step_size:
            lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                step / max(cycle_first_step_size, 1))
        elif step < end:
            lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / max(second, 1))
        elif decay_step_size > 0:
            lr = cycle_min_lr / (1 + (step - end) // decay_step_size
                                 * decay_lr_rate)
        else:
            lr = cycle_min_lr
        return float(max(lr, 0.0))
    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    """LRRangeTest: lr grows linearly (or in stairs) with the step."""
    def sched(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return float(lr_range_test_min_lr
                     * (1 + interval * lr_range_test_step_rate))
    return sched


_REGISTRY = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
}


def build_schedule(name: str, params: Dict[str, Any]) -> Schedule:
    """Build from a "scheduler" config block."""
    key = name.lower().replace("_", "")
    if key not in _REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; supported: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**params)


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)
