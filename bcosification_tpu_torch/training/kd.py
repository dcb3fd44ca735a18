"""CLIP knowledge distillation with the SigLIP criterion (counterpart of
``bcosification_tpu/training/kd.py``).

One step: the frozen CLIP teacher sees the raw [0, 1] images normalised with
CLIP's mean and std (3 channels), the B-cosified student sees them with
their inverse stacked on the channels (AddInverse, 6 channels; it
normalises them itself) in train mode, updating its BN statistics. Both
features are L2-normalised (eps 1e-8 outside the norm) and scored by the
SigLIP loss with a fixed logit scale and bias. An attn-unpool student emits
batch-first features [B, HW, D]; they are swapped to the loss's
location-first [HW, B, D] before it.

``amp``: the images go to bf16, so both towers compute in bf16 over f32
parameters. The teacher's features come out in f32 and the student's in
bf16; each is normalised in its own dtype, and the loss runs in the
promoted dtype (f32), as in the JAX step.

Under a process group of W ranks (``parallel/dp.py``) each rank holds
its rows of the global batch, and ``loss_mode`` says how the pairwise loss
spans them (JAX ``make_kd_train_step(loss_mode=...)``):

- "global" (the default): the full-matrix loss of the global batch. Each
  rank gathers every rank's student and teacher features (the student's
  with their gradient; an attn-unpool student's [HW, B, D] on the batch
  axis 1) and scores all against all: the same loss on every rank.
- "ring": each rank's ``SigLipLoss(world_size=W)`` ring loss, its images
  against the texts that travel around the ring; the mean over the ranks
  is the loss (JAX ``pmean``).

Both equal the one-process loss of the global batch. The gradients are then
averaged over the ranks (``training/steps.py``), and the loss the step
returns is the mean over the ranks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from bcosification_tpu_torch.data.presets import CLIP_MEAN, CLIP_STD
from bcosification_tpu_torch.losses import SigLipLoss
from bcosification_tpu_torch.parallel import dp
from bcosification_tpu_torch.training import agc as agc_lib
from bcosification_tpu_torch.training import ema as ema_lib
from bcosification_tpu_torch.training.steps import (
    AGC_CLIP_FACTOR,
    TrainState,
    apply_update,
    mean_over_ranks_,
    sync_each_micro_step,
)

__all__ = ["kd_forward_features", "kd_loss", "make_kd_train_step", "LOSS_MODES"]

LOSS_MODES = ("global", "ring", "local")


def _l2(x: torch.Tensor) -> torch.Tensor:
    # the eps guards 0/0 for degenerate (random-init) features
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def kd_forward_features(student: nn.Module, teacher: nn.Module, images: torch.Tensor, *,
                        train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(teacher features, student output) of raw [0, 1] NHWC images. The
    teacher runs without gradient; with ``train`` the student uses batch
    statistics and updates its running ones in place."""
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    with torch.no_grad():
        t_feat = teacher((images - mean) / std)
    x6 = torch.cat([images, 1.0 - images], dim=-1)
    return t_feat, student(x6, train=train)


def kd_loss(s_out: torch.Tensor, t_feat: torch.Tensor, logit_scale: float = 10.0,
            logit_bias: float = -10.0, cos_power: int = 0,
            loss_mode: str = "global") -> torch.Tensor:
    """The SigLIP loss of the L2-normalised student and teacher features; an
    attn-unpool student's [B, HW, D] go location-first first. Under a
    process group the features are this rank's rows and ``loss_mode``
    ("global" or "ring", see the module docstring) spans the ranks;
    "local" scores this process's batch alone."""
    if loss_mode not in LOSS_MODES:
        raise ValueError(f"loss_mode must be one of {LOSS_MODES}, got {loss_mode!r}")
    s_feat, t_feat = _l2(s_out), _l2(t_feat)
    if s_feat.dim() == 3:  # contiguous, as a gather returns it: one layout, one rounding
        s_feat = s_feat.transpose(0, 1).contiguous()
    dtype = torch.promote_types(s_feat.dtype, t_feat.dtype)
    s_feat, t_feat = s_feat.to(dtype), t_feat.to(dtype)
    if loss_mode == "global" and dp.is_initialized():
        s_feat = dp.all_gather(s_feat, dim=1 if s_feat.dim() == 3 else 0)
        t_feat = dp.all_gather(t_feat, dim=0)
    ring = dp.world_size() if loss_mode == "ring" else 1
    return SigLipLoss(world_size=ring)(s_feat, t_feat, logit_scale, logit_bias,
                                       cos_scaling=cos_power)


def make_kd_train_step(
    teacher: nn.Module,
    lr_schedule: Optional[Union[float, Callable[[int], float]]] = None,
    *,
    logit_scale: float = 10.0,
    logit_bias: float = -10.0,
    cos_power: int = 0,
    use_agc: bool = True,
    ema_decay: Optional[float] = None,
    ema_steps: int = 32,
    accumulate: int = 1,
    amp: bool = False,
    loss_mode: str = "global",
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, {"loss"})`` of the KD recipe:
    ``state`` holds the student; ``batch["image"]`` raw [0, 1] NHWC images
    on its device (this rank's rows under a process group). ``lr_schedule``:
    a schedule(micro-step) -> lr, a constant, or None to keep the
    optimizer's own lr; ``accumulate`` micro-batches per update
    (``steps.apply_update``); ``loss_mode`` "global" or "ring"."""
    if loss_mode not in ("global", "ring"):
        raise ValueError(f"loss_mode must be 'global' or 'ring', got {loss_mode!r}")
    teacher.requires_grad_(False)
    sync_now = sync_each_micro_step(accumulate, use_agc)

    def train_step(state: TrainState, batch):
        model = state.model
        images = batch["image"].to(torch.bfloat16) if amp else batch["image"]
        model.zero_grad(set_to_none=True)
        t_feat, s_out = kd_forward_features(model, teacher, images, train=True)
        loss = kd_loss(s_out, t_feat, logit_scale, logit_bias, cos_power, loss_mode)
        loss.backward()
        if sync_now:
            dp.average_gradients(p.grad for p in model.parameters())
        if use_agc:
            agc_lib.adaptive_clip_grads_(model, AGC_CLIP_FACTOR)
        apply_update(state, lr_schedule, accumulate, sync=not sync_now)
        state.step += 1
        if ema_decay is not None and state.ema is not None:
            ema_lib.maybe_ema_update(state.ema, model, ema_decay, state.step, ema_steps)
        metrics = {"loss": loss.detach()}
        mean_over_ranks_(metrics, "loss")
        return state, metrics

    return train_step
