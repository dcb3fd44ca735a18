"""A Sequential that passes the (train, explain) flags down (counterpart of
``bcosification_tpu/modules/containers.py``, the reference's
``BcosSequential``).

``call_with_flags`` hands ``train`` and ``explain`` to a layer only when
its forward (or a plain function's signature) takes them. The released
B-cos ViTs are ``BcosSequential(model, LogitLayer)`` in the reference,
hence the ``0.`` prefix of their checkpoints' keys.
"""
from __future__ import annotations

import inspect
from typing import Callable

from torch import nn

__all__ = ["BcosSequential", "call_with_flags"]


def call_with_flags(layer: Callable, x, *, train: bool, explain: bool, **kw):
    """layer(x, ...) with only the flags its signature takes."""
    fn = layer.forward if isinstance(layer, nn.Module) else layer
    try:
        params = inspect.signature(fn).parameters
    except (ValueError, TypeError):
        return layer(x, **kw)
    flags = {k: v for k, v in (("train", train), ("explain", explain)) if k in params}
    return layer(x, **flags, **kw)


class BcosSequential(nn.Sequential):
    """nn.Sequential whose forward passes the flags to the layers that take them."""

    def forward(self, x, *, train: bool = False, explain: bool = False):
        for layer in self:
            x = call_with_flags(layer, x, train=train, explain=explain)
        return x
