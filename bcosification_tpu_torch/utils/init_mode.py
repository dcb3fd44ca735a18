"""Shape-only builds for the model factories (counterpart of
``bcosification_tpu/utils/init_mode.py``).

The release importer (``bcosify/release_import.py``) and structural tests
need only a model's parameter names and shapes. Inside ``abstract_init()``
the registry's factories (``models/pretrained.py``) and the vit_final
factory build on the ``meta`` device: every tensor has its shape and dtype
and no memory, and no initialisation runs (a ``torch.Generator`` has no
meta device, so the seeded init is skipped). The switch is thread-local,
so a conversion in one thread cannot turn another thread's build into a
shape-only one.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from bcosification_tpu_torch.device import resolve_device

__all__ = ["abstract_init", "abstract_init_on", "build_device", "build_generator"]

_STATE = threading.local()


@contextmanager
def abstract_init():
    """Within this context the factories build shape-only models."""
    prev = getattr(_STATE, "on", False)
    _STATE.on = True
    try:
        yield
    finally:
        _STATE.on = prev


def abstract_init_on() -> bool:
    return getattr(_STATE, "on", False)


def build_device(device=None) -> torch.device:
    """Where a factory builds: ``meta`` under ``abstract_init``, else
    ``resolve_device(device)`` (the GPU unless the caller asks for the CPU)."""
    return torch.device("meta") if abstract_init_on() else resolve_device(device)


def build_generator(device: torch.device, seed: int) -> Optional[torch.Generator]:
    """The seeded init's generator on ``device``; None on ``meta``, where
    nothing is initialised."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))
