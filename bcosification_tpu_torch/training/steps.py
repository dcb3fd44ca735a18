"""Train and eval steps (counterpart of ``bcosification_tpu/training/steps.py``).

``TrainState`` holds the model being trained (a copy of the caller's, with
every parameter trainable), its optimizer, the step count and an optional
EMA copy of the model. ``make_train_step`` builds the supervised step of
the recipe: forward with batch-statistics BN (``train=True``), the loss on
f32 logits, backward, the gradient norm, AGC or a global-norm clip (not
both), the learning rate of this step written into the optimizer, the
update, and the EMA every ``ema_steps`` steps. The step returns its metrics
as tensors on the model's device and does not wait for the device.

``amp``: the input goes to bf16, so activations are bf16 and every op casts
its weights to bf16; parameters, gradients and the optimizer state stay f32,
and the logits go to f32 before the loss.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from bcosification_tpu_torch.optim.optimizer_factory import set_lr
from bcosification_tpu_torch.training import agc as agc_lib
from bcosification_tpu_torch.training import ema as ema_lib

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step"]

AGC_CLIP_FACTOR = 0.01


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[nn.Module] = None

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "ema": None if self.ema is None else self.ema.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])


def create_train_state(model: nn.Module,
                       make_optimizer: Callable[[nn.Module], torch.optim.Optimizer],
                       with_ema: bool = False, device=None) -> TrainState:
    """A state around a copy of ``model`` on ``device`` (default: the
    model's own; never the caller's model itself: training updates it in
    place), the optimizer ``make_optimizer`` builds over the copy, and an
    EMA copy when asked."""
    model = copy.deepcopy(model).to(device).requires_grad_(True)
    ema = copy.deepcopy(model).requires_grad_(False) if with_ema else None
    return TrainState(model=model, optimizer=make_optimizer(model), ema=ema)


def _dense_to_sparse(label: torch.Tensor) -> torch.Tensor:
    return label if label.ndim == 1 else label.argmax(-1)


def make_train_step(
    criterion: Callable,
    lr_schedule: Optional[Union[float, Callable[[int], float]]] = None,
    *,
    use_agc: bool = False,
    gradient_clip_val: Optional[float] = None,
    ema_decay: Optional[float] = None,
    ema_steps: int = 32,
    b_schedule: Optional[Callable] = None,
    b_tx: Any = None,
    amp: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    "image" (NHWC) and "label" (indices or dense) on the model's device.
    ``lr_schedule``: a schedule(step) -> lr, a constant, or None to keep
    the optimizer's own lr."""
    if use_agc and gradient_clip_val:
        raise ValueError("use_agc and gradient_clip_val are mutually exclusive: AGC would "
                         "silently replace the configured global-norm clip")
    if b_schedule is not None or b_tx is not None:
        raise NotImplementedError("b_schedule and b_tx train learnable b, which comes in "
                                  "port slice 6")

    def train_step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        image = batch["image"].to(torch.bfloat16) if amp else batch["image"]
        opt.zero_grad(set_to_none=True)
        out = model(image, train=True).float()
        loss = criterion(out, batch["label"])
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        if use_agc:
            agc_lib.adaptive_clip_grads_(model, AGC_CLIP_FACTOR)
        elif gradient_clip_val:
            torch.nn.utils.clip_grads_with_norm_(params, gradient_clip_val, grad_norm)
        if lr_schedule is not None:
            set_lr(opt, lr_schedule(state.step) if callable(lr_schedule) else lr_schedule)
        opt.step()
        state.step += 1
        if ema_decay is not None and state.ema is not None:
            ema_lib.maybe_ema_update(state.ema, model, ema_decay, state.step, ema_steps)
        label = _dense_to_sparse(batch["label"])
        metrics = {
            "loss": loss.detach(),
            "acc1": (out.detach().argmax(-1) == label).float().mean(),
            "grad_norm": grad_norm,
        }
        return state, metrics

    return train_step


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
