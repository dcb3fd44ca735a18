"""Profiling (counterpart of ``bcosification_tpu/utils/profiling.py``).

``trace(logdir, device)`` records a ``torch.profiler`` trace of its block,
with the card's activities when ``device`` is a CUDA device, and writes it
to ``logdir`` as a Chrome trace (``trace.json``), which TensorBoard's
profiler plugin and Perfetto read. ``StepTimer`` counts items per second
over the steps after a warm-up.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["trace", "start_trace", "stop_trace", "StepTimer"]


def start_trace(device=None) -> torch.profiler.profile:
    """A started profiler over the host and, on a CUDA ``device``, the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir) -> Path:
    """Stop ``prof`` (after the card's work is done) and write its Chrome
    trace to ``<logdir>/trace.json``; returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(logdir, device=None):
    """Trace the block: ``with trace("/tmp/trace", device): run_steps()``."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, logdir)


class StepTimer:
    """Throughput with the first ``warmup_steps`` steps left out."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._items = 0
        self._t0: Optional[float] = None

    def step(self, n_items: int) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._items = 0
        elif self._count > self.warmup_steps:
            self._items += n_items

    def throughput(self) -> Optional[float]:
        if self._t0 is None or self._items == 0:
            return None
        return self._items / (time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        tp = self.throughput()
        return {"items_per_s": tp or float("nan"), "steps": self._count}
