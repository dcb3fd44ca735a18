"""Train and eval steps (counterpart of ``bcosification_tpu/training/steps.py``).

``TrainState`` holds the model being trained (a copy of the caller's, with
every parameter trainable), its optimizer, the step count, an optional EMA
copy of the model, the optional optimizer over the learnable b parameters
(the manual-optim variant) and, under gradient accumulation, the running
mean of the micro-batch gradients. ``make_train_step`` builds the supervised
step of the recipe: forward with batch-statistics BN (``train=True``), the
loss on f32 logits, backward, the gradient norm, AGC or a global-norm clip
(not both), then the update (``apply_update``): the learning rate of this
step written into the optimizer, the optimizer step, and the EMA every
``ema_steps`` steps. The step returns its metrics as tensors on the model's
device and does not wait for the device.

``accumulate`` k > 1 is ``optax.MultiSteps``: each micro-batch's gradient
(clipped per micro-batch, as the JAX step clips before the wrapper) enters
a running mean, acc += (g - acc) / (n + 1), and the optimizers step on the
mean once every k micro-batches; ``state.step`` counts micro-batches.

Learnable b: ``b_schedule(step) -> b`` writes every b parameter before the
forward and again, with the next step's value, after the update (the
closed form of the reference's forced-gradient hook, ``make_linear_b_schedule``);
``state.b_optimizer`` steps the b parameters on their raw gradients.

``amp``: the input goes to bf16, so activations are bf16 and every op casts
its weights to bf16; parameters, gradients and the optimizer state stay f32,
and the logits go to f32 before the loss.

Data parallelism (``parallel/dp.py``): under a process group of W ranks
each rank steps on its own rows of the global batch (the same number
on every rank), its norms take the global batch's moments, and the
gradients are averaged over the ranks by an explicit all-reduce after the
backward (one flat buffer per dtype), before the gradient norm, AGC or the
clip, the b optimizer's raw gradients and the accumulation: so each
micro-batch's gradient is the global batch's, as the JAX data mesh computes
it. Under accumulation with no per-micro-batch clip (no AGC, no clip value)
the micro-steps do not all-reduce: the accumulated mean is averaged once,
at the micro-step that completes the update (the mean is linear), and
``grad_norm`` is then the rank's own. The loss and accuracy the step
returns are means over the ranks.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from bcosification_tpu_torch.optim.optimizer_factory import is_b_param, set_lr
from bcosification_tpu_torch.parallel import dp
from bcosification_tpu_torch.training import agc as agc_lib
from bcosification_tpu_torch.training import ema as ema_lib

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "apply_update", "set_b_params", "make_linear_b_schedule", "mean_over_ranks_",
           "sync_each_micro_step"]

AGC_CLIP_FACTOR = 0.01


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[nn.Module] = None
    b_optimizer: Optional[torch.optim.Optimizer] = None
    # under gradient accumulation: the micro-batches taken since the last
    # update, and the mean of their gradients by ("main"|"b", parameter name)
    mini_step: int = 0
    accumulated: Dict[Tuple[str, str], torch.Tensor] = dataclasses.field(default_factory=dict)

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "ema": None if self.ema is None else self.ema.state_dict(),
                "b_optimizer": (None if self.b_optimizer is None
                                else self.b_optimizer.state_dict()),
                "mini_step": self.mini_step,
                "accumulated": {"/".join(k): v for k, v in self.accumulated.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        if self.b_optimizer is not None:
            self.b_optimizer.load_state_dict(state["b_optimizer"])
        self.mini_step = int(state.get("mini_step", 0))
        self.accumulated = {tuple(k.split("/", 1)): v
                            for k, v in (state.get("accumulated") or {}).items()}


def create_train_state(model: nn.Module,
                       make_optimizer: Callable[[nn.Module], torch.optim.Optimizer],
                       with_ema: bool = False, device=None,
                       make_b_optimizer: Optional[Callable[[nn.Module],
                                                           torch.optim.Optimizer]] = None
                       ) -> TrainState:
    """A state around a copy of ``model`` on ``device`` (default: the
    model's own; never the caller's model itself: training updates it in
    place), the optimizer ``make_optimizer`` builds over the copy, an EMA
    copy when asked, and the b optimizer ``make_b_optimizer`` builds when
    given and the model has b parameters."""
    model = copy.deepcopy(model).to(device).requires_grad_(True)
    ema = copy.deepcopy(model).requires_grad_(False) if with_ema else None
    has_b = any(is_b_param(n) for n, _ in model.named_parameters())
    b_optimizer = make_b_optimizer(model) if make_b_optimizer is not None and has_b else None
    return TrainState(model=model, optimizer=make_optimizer(model), ema=ema,
                      b_optimizer=b_optimizer)


@torch.no_grad()
def set_b_params(model: nn.Module, value) -> None:
    """Overwrite every learnable-b parameter with ``value``: the explicit
    form of the reference's gradient-hook b schedule."""
    for name, p in model.named_parameters():
        if is_b_param(name):
            p.fill_(value)


def make_linear_b_schedule(b_at_start: float = 1.0, b_at_end: float = 2.0, b_lr: float = 1e-4,
                           world_size: int = 1, batch_size: int = 1
                           ) -> Callable[[int], np.float32]:
    """The closed form of the reference's forced-gradient b interpolation:
    b starts at ``b_at_start + 1e-6`` (away from the b == 1 fast path) and
    grows by ``b_lr * world_size * batch_size`` per step, frozen at the
    first value >= ``b_at_end`` (the crossing step overshoots and stays):
    b(t) = start + min(t, K) * delta in f32, K the first t that crosses.
    ``world_size * batch_size`` is the global batch of one step."""
    start = float(b_at_start) + 1e-6
    delta = float(b_lr) * int(world_size) * int(batch_size)
    if delta <= 0:
        raise ValueError(f"linear_b needs a positive increment, got {delta}")
    k_freeze = 0 if start >= float(b_at_end) else math.ceil((float(b_at_end) - start) / delta)

    def schedule(step: int) -> np.float32:
        return np.float32(start) + np.float32(min(int(step), k_freeze)) * np.float32(delta)

    return schedule


def _dense_to_sparse(label: torch.Tensor) -> torch.Tensor:
    return label if label.ndim == 1 else label.argmax(-1)


def _named_grads(model: nn.Module, b: bool) -> Dict[str, torch.Tensor]:
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None and is_b_param(n) == b}


def sync_each_micro_step(accumulate: int, clipped: bool) -> bool:
    """Whether a data-parallel step averages its gradients over the ranks
    at every micro-step (always, unless it accumulates with no
    per-micro-batch clip: then ``apply_update`` averages the mean once)."""
    return accumulate == 1 or clipped


def apply_update(state: TrainState, lr_schedule=None, accumulate: int = 1,
                 b_grads: Optional[Dict[str, torch.Tensor]] = None,
                 sync: bool = False) -> bool:
    """The optimizer side of a train step, after the backward pass and the
    clipping: the gradients in ``.grad`` go to the main optimizer and
    ``b_grads`` (the raw ones) to ``state.b_optimizer``, both through the
    running mean over ``accumulate`` micro-batches; the learning rate is
    ``lr_schedule(state.step)`` of the micro-step that completes the
    update. ``sync``: average the gradients the optimizers step on over the
    ranks first (the deferred all-reduce of an accumulated update). Returns
    True when the optimizers stepped."""
    model = state.model
    grads = {("main", n): p.grad for n, p in model.named_parameters() if p.grad is not None}
    if b_grads is not None:
        grads.update({("b", n): g for n, g in b_grads.items()})
    if accumulate > 1:
        n = state.mini_step
        acc = state.accumulated
        for key, g in grads.items():  # optax.MultiSteps' mean (Welford)
            acc[key] = g.detach().clone() if n == 0 or key not in acc else (
                acc[key] + (g - acc[key]) / (n + 1))
        if n + 1 < accumulate:
            state.mini_step = n + 1
            return False
        grads, state.accumulated, state.mini_step = acc, {}, 0
    if sync:
        dp.average_gradients(grads.values())
    params = dict(model.named_parameters())
    for (group, name), g in grads.items():
        if group == "main":
            params[name].grad = g
    if lr_schedule is not None:
        set_lr(state.optimizer,
               lr_schedule(state.step) if callable(lr_schedule) else lr_schedule)
    state.optimizer.step()
    if state.b_optimizer is not None:
        for (group, name), g in grads.items():
            if group == "b":
                params[name].grad = g
        state.b_optimizer.step()
    return True


def make_train_step(
    criterion: Callable,
    lr_schedule: Optional[Union[float, Callable[[int], float]]] = None,
    *,
    use_agc: bool = False,
    gradient_clip_val: Optional[float] = None,
    ema_decay: Optional[float] = None,
    ema_steps: int = 32,
    b_schedule: Optional[Callable[[int], float]] = None,
    accumulate: int = 1,
    amp: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    "image" (NHWC) and "label" (indices or dense) on the model's device.
    ``lr_schedule``: a schedule(micro-step) -> lr, a constant, or None to
    keep the optimizer's own lr. ``ema_steps`` counts micro-steps (the
    trainer passes the config's ``steps * accumulate``)."""
    if use_agc and gradient_clip_val:
        raise ValueError("use_agc and gradient_clip_val are mutually exclusive: AGC would "
                         "silently replace the configured global-norm clip")

    def train_step(state: TrainState, batch):
        model = state.model
        if b_schedule is not None:
            set_b_params(model, b_schedule(state.step))
        image = batch["image"].to(torch.bfloat16) if amp else batch["image"]
        model.zero_grad(set_to_none=True)
        out = model(image, train=True).float()
        loss = criterion(out, batch["label"])
        loss.backward()
        if sync_now:
            dp.average_gradients(p.grad for p in model.parameters())
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        b_grads = None
        if state.b_optimizer is not None:  # the b optimizer takes the raw gradients
            b_grads = {n: g.clone() for n, g in _named_grads(model, b=True).items()}
        if use_agc:
            agc_lib.adaptive_clip_grads_(model, AGC_CLIP_FACTOR)
        elif gradient_clip_val:
            torch.nn.utils.clip_grads_with_norm_(
                [p for p in model.parameters() if p.grad is not None], gradient_clip_val,
                grad_norm)
        apply_update(state, lr_schedule, accumulate, b_grads, sync=not sync_now)
        state.step += 1
        if b_schedule is not None:
            set_b_params(model, b_schedule(state.step))
        if ema_decay is not None and state.ema is not None:
            ema_lib.maybe_ema_update(state.ema, model, ema_decay, state.step, ema_steps)
        label = _dense_to_sparse(batch["label"])
        metrics = {
            "loss": loss.detach(),
            "acc1": (out.detach().argmax(-1) == label).float().mean(),
            "grad_norm": grad_norm,
        }
        mean_over_ranks_(metrics, "loss", "acc1")
        return state, metrics

    sync_now = sync_each_micro_step(accumulate, use_agc or bool(gradient_clip_val))
    return train_step


def mean_over_ranks_(metrics: Dict[str, torch.Tensor], *keys: str) -> None:
    """Replace ``metrics[k]`` of each key by its mean over the ranks (one
    all-reduce; nothing without a group)."""
    if dp.is_initialized():
        w = dp.world_size()
        vals = [metrics[k].detach().clone() for k in keys]
        dp.reduce_sum_(*vals)
        for k, v in zip(keys, vals):
            metrics[k] = v / w


def make_eval_step(test_criterion: Optional[Callable] = None, use_ema: bool = False):
    """``eval_step(state, batch) -> {"correct1", "correct5", "count"[, "loss"]}``
    (sums over the batch; the loss summed too) with eval-mode BN."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.ema if use_ema else state.model
        out = model(batch["image"], train=False).float()
        label = _dense_to_sparse(batch["label"])
        topk = out.topk(min(5, out.shape[-1]), dim=-1).indices
        metrics = {
            "correct1": (out.argmax(-1) == label).float().sum(),
            "correct5": (topk == label[:, None]).any(-1).float().sum(),
            "count": float(label.shape[0]),
        }
        if test_criterion is not None:
            metrics["loss"] = test_criterion(out, batch["label"]) * label.shape[0]
        return metrics

    return eval_step
