"""Guided-backprop and DeepLIFT ReLU gating (counterpart of
``bcosification_tpu/ops/guided.py``).

The model's ReLU call sites route through :func:`relu`. Inside
:func:`guided_backprop` it records a ReLU whose backward keeps only the
positive gradients of positively activated units; inside :func:`deeplift`
one whose backward is DeepLIFT's Rescale multiplier on a paired batch. The
forward value is the ReLU's in every mode. Autograd records the backward
when the forward runs, so only the forward has to run inside the context;
the modes live in ``contextvars``, so other threads see the plain ReLU.

K1 and K2 (``ops/cuda/bcos_conv1x1.py``) have the plain ReLU mask built
in, so under either mode the B-cos layers keep their convs off K1
(``modules/bcos_layers.py``), as the JAX package keeps them off its Pallas
kernel.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["relu", "guided_backprop", "guided_mode", "deeplift", "deeplift_mode"]

_GUIDED = contextvars.ContextVar("bcos_guided_backprop", default=False)
_DEEPLIFT = contextvars.ContextVar("bcos_deeplift", default=False)


def guided_mode() -> bool:
    """True inside :func:`guided_backprop`."""
    return _GUIDED.get()


def deeplift_mode() -> bool:
    """True inside :func:`deeplift`."""
    return _DEEPLIFT.get()


@contextlib.contextmanager
def guided_backprop():
    token = _GUIDED.set(True)
    try:
        yield
    finally:
        _GUIDED.reset(token)


@contextlib.contextmanager
def deeplift():
    """DeepLIFT (Rescale rule). Inside it the model must run on a PAIRED
    batch ``cat([x, x0])`` (the inputs over their baselines, equal halves).
    Every ReLU then backpropagates m = (relu(x) - relu(x0)) / (x - x0) for
    both halves, and the ordinary ReLU gradient where |x - x0| < 1e-7. The
    other ops of an explanation-mode B-cos forward are linear, so the
    attributions (x - x0) * grad sum to f(x) - f(x0)."""
    token = _DEEPLIFT.set(True)
    try:
        yield
    finally:
        _DEEPLIFT.reset(token)


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x > 0)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return torch.where(pos & (g > 0), g, torch.zeros_like(g))


class _DeepLiftReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        half = x.shape[0] // 2
        xa, xr = x[:half], x[half:]
        delta = xa - xr
        near = delta.abs() < 1e-7
        rescale = (torch.relu(xa) - torch.relu(xr)) / torch.where(near, torch.ones_like(delta),
                                                                   delta)
        m = torch.where(near, (xa > 0).to(x.dtype), rescale)
        return g * torch.cat([m, m], dim=0)


def relu(x: torch.Tensor) -> torch.Tensor:
    """The model path's ReLU: plain, guided under :func:`guided_backprop`,
    the paired Rescale under :func:`deeplift`. The same values in every
    mode; only the gradient differs."""
    if _GUIDED.get():
        return _GuidedReLU.apply(x)
    if _DEEPLIFT.get():
        return _DeepLiftReLU.apply(x)
    return torch.relu(x)
