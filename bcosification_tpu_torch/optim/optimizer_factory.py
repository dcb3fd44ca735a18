"""Optimizer factory over ``torch.optim`` (counterpart of
``bcosification_tpu/optim/optimizer_factory.py``).

adam, adamw, sgd and rmsprop with the JAX package's defaults: no weight
decay unless asked for (coupled L2 for adam/sgd/rmsprop, decoupled for
adamw), RMSprop with alpha 0.9 and eps 0.0316 added outside the square
root and, as optax orders it, the lr applied before the momentum trace
(``RMSprop``). ``bcosify`` (any value but None) splits the parameters as the
JAX package's two-optimizer set-up does: the optimizer takes every
parameter but the learnable ``b`` ones, or, with ``b_opt``, only those.
"""
from __future__ import annotations

import copy
from typing import Union

import torch
from torch import nn

__all__ = ["OptimizerFactory", "RMSprop", "is_b_param", "set_lr"]


def is_b_param(name: str) -> bool:
    """The learnable b parameters are the leaves literally named 'b'."""
    return name.rsplit(".", 1)[-1] == "b"


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every parameter group (the schedule's value for the
    coming step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


class RMSprop(torch.optim.Optimizer):
    """RMSprop in optax's order (``optax.rmsprop(eps_in_sqrt=False)``): the
    update g / (sqrt(v) + eps) is scaled by the step's lr, then summed into
    the momentum trace. ``torch.optim.RMSprop`` scales the trace by the lr
    instead, which differs as soon as a schedule changes the lr. Coupled L2
    weight decay is added to the gradient first."""

    def __init__(self, params, lr: float, alpha: float = 0.9, eps: float = 0.0316,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    if group["momentum"]:
                        state["momentum_buffer"] = torch.zeros_like(p)
                square_avg = state["square_avg"]
                square_avg.mul_(group["alpha"]).addcmul_(g, g, value=1 - group["alpha"])
                update = g.div(square_avg.sqrt().add_(group["eps"])).mul_(-group["lr"])
                if group["momentum"]:
                    update = state["momentum_buffer"].mul_(group["momentum"]).add_(update)
                p.add_(update)
        return loss


class OptimizerFactory:
    """Configured like the JAX factory: (name, lr, **kwargs incl.
    weight_decay, momentum, betas, eps, bcosify, b_opt). ``create(model)``
    returns the optimizer over the model's trainable parameters."""

    def __init__(self, name: str, lr: Union[int, float], **kwargs):
        if name.lower() not in ("adamw", "adam", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.args = dict(lr=lr, **kwargs)

    def create(self, model: nn.Module) -> torch.optim.Optimizer:
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if self.args.get("bcosify", None) is not None:
            want_b = bool(self.args.get("b_opt", False))
            named = [(n, p) for n, p in named if is_b_param(n) == want_b]
        params = [p for _, p in named]
        args = {k: v for k, v in self.args.items() if k not in ("bcosify", "b_opt")}
        name = self.name.lower()
        lr = args.pop("lr")
        wd = args.pop("weight_decay", 0.0) or 0.0
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=args.pop("momentum", 0.0) or 0.0,
                                   nesterov=args.pop("nesterov", False), weight_decay=wd)
        if name == "rmsprop":
            return RMSprop(params, lr=lr, alpha=args.pop("alpha", 0.9),
                           eps=args.pop("eps", 0.0316), momentum=args.pop("momentum", 0.0) or 0.0,
                           weight_decay=wd)
        betas = tuple(args.pop("betas", (0.9, 0.999)))
        eps = args.pop("eps", 1e-8)
        opt = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        return opt(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)

    def with_name(self, new_name: str) -> "OptimizerFactory":
        args = copy.deepcopy(self.args)
        lr = args.pop("lr")
        return type(self)(new_name, lr, **args)

    def with_args(self, **kwargs) -> "OptimizerFactory":
        """A copy with ``kwargs`` added or overridden; the other arguments
        are kept."""
        if "lr" in kwargs or "name" in kwargs:
            raise ValueError("with_args takes neither lr nor name")
        args = copy.deepcopy(self.args)
        lr = args.pop("lr")
        args.update(kwargs)
        return type(self)(self.name, lr, **args)

    @property
    def lr(self) -> float:
        return self.args["lr"]

    def __repr__(self):
        return (f"{type(self).__name__}(optimizer='{self.name}'"
                + "".join(f", {k}={v}" for k, v in self.args.items()) + ")")

    def __to_config__(self):
        return dict(name=self.name.lower(), **self.args)
