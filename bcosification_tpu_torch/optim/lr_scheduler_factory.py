"""Learning-rate schedules with torch scheduler semantics (counterpart of
``bcosification_tpu/optim/lr_scheduler_factory.py``).

StepLR, CosineAnnealingLR and ExponentialLR with constant or linear warmup,
on an epoch or a step interval. ``create`` returns ``schedule(step) -> lr``,
a pure function of the optimizer step count (epoch intervals quantise it to
epochs); the train step writes its value into the param groups before each
update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, Optional

__all__ = ["LRSchedulerFactory"]


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


@dataclasses.dataclass(frozen=True)
class LRSchedulerFactory:
    name: str
    step_size: int = 30  # epochs (StepLR)
    gamma: float = 0.1
    epochs: Optional[int] = None
    lr_min: float = 0.0
    interval: Literal["epoch", "step"] = "epoch"
    warmup_epochs: Optional[int] = None
    warmup_steps: Optional[int] = None
    warmup_method: str = "constant"
    warmup_decay: float = 0.01

    def __post_init__(self):
        if self.name.lower() not in ("steplr", "cosineannealinglr", "exponentiallr"):
            raise ValueError(f"unknown lr scheduler {self.name!r}")
        if self.warmup_method.lower() not in ("linear", "constant"):
            raise ValueError(f"unknown warmup method {self.warmup_method!r}")
        if self.interval not in ("epoch", "step"):
            raise ValueError(f"unknown interval {self.interval!r}")
        if self.name.lower() == "cosineannealinglr" and not (self.epochs and self.epochs > 0):
            raise ValueError("cosineannealinglr needs epochs > 0")
        if self.warmup_steps is not None and self.warmup_epochs is not None:
            raise ValueError("give warmup_steps or warmup_epochs, not both")
        if self.interval != "step" and self.warmup_steps is not None:
            raise ValueError("For warmup_steps, interval must be 'step'")

    def create(self, base_lr: float, steps_per_epoch: int) -> Callable[[int], float]:
        name = self.name.lower()
        if self.interval == "epoch":
            def to_t(step):
                return step // steps_per_epoch
            warmup_iters = self.warmup_epochs or 0
        else:
            def to_t(step):
                return step
            if self.warmup_steps is not None:
                warmup_iters = self.warmup_steps
            elif self.warmup_epochs is not None:
                warmup_iters = self.warmup_epochs * steps_per_epoch
            else:
                warmup_iters = 0

        # the main scheduler's horizon excludes the warmup, as torch's does
        if name == "cosineannealinglr":
            t_max = self.epochs - (self.warmup_epochs or 0)
            if self.interval == "step":
                t_max = self.epochs * steps_per_epoch - warmup_iters
        elif name == "steplr":
            step_size = self.step_size * (steps_per_epoch if self.interval == "step" else 1)

        def main_lr(t):
            if name == "steplr":
                return base_lr * self.gamma ** (t // step_size)
            if name == "cosineannealinglr":
                frac = _clip01(t / max(t_max, 1))
                return self.lr_min + (base_lr - self.lr_min) * 0.5 * (1.0 + math.cos(math.pi * frac))
            return base_lr * self.gamma ** t

        linear = self.warmup_method.lower() == "linear"

        def schedule(step: int) -> float:
            t = to_t(int(step))
            if t >= warmup_iters:
                return float(main_lr(t - warmup_iters))
            if linear:  # torch LinearLR: factor warmup_decay -> 1 over the warmup
                frac = _clip01(t / max(warmup_iters, 1))
                return base_lr * (self.warmup_decay + (1 - self.warmup_decay) * frac)
            return base_lr * self.warmup_decay

        return schedule

    def __to_config__(self):
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
