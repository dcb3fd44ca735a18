"""Classification losses of the supervised recipes (counterpart of
``bcosification_tpu/losses.py``: ``binary_cross_entropy_with_logits``,
``cross_entropy``, ``BinaryCrossEntropyLoss``, ``CrossEntropyLoss`` and
``UniformOffLabelsBCEWithLogitsLoss``).

Targets are class indices [N] or dense [N, C]; dense targets of another
shape than the logits are one-hot encoded by the BCE losses. The softmax
cross-entropy of the standard ViT baselines takes either: dense targets
are class probabilities (mixup's). ``SigLipLoss`` is the CLIP
recipe's sigmoid pairwise loss, in one process; its ring exchange across
processes comes with port slice 8 (distribution).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "binary_cross_entropy_with_logits",
    "cross_entropy",
    "BinaryCrossEntropyLoss",
    "CrossEntropyLoss",
    "UniformOffLabelsBCEWithLogitsLoss",
    "SigLipLoss",
]


def _one_hot_if_needed(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if target.shape != x.shape:
        target = F.one_hot(target.long(), x.shape[-1])
    return target.to(x.dtype)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_cross_entropy_with_logits(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    pos_weight: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """-[t log sig(x) + (1 - t) log sig(-x)], with an optional pos_weight on
    the first term and an elementwise weight; the JAX package's formula."""
    log_sig_x = -F.softplus(-x)
    log_sig_neg_x = -F.softplus(x)
    pos = target * log_sig_x if pos_weight is None else pos_weight * target * log_sig_x
    loss = -(pos + (1 - target) * log_sig_neg_x)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy with integer labels over the last axis."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]
    return _reduce(nll, reduction)


@dataclasses.dataclass(frozen=True)
class BinaryCrossEntropyLoss:
    """BCE with one-hot conversion, optional label smoothing and target
    thresholding: the test criterion of the recipe."""

    smoothing: float = 0.0
    target_threshold: Optional[float] = None
    reduction: str = "mean"

    def __call__(self, x, target):
        assert x.shape[0] == target.shape[0]
        num_classes = x.shape[-1]
        target = _one_hot_if_needed(x, target)
        if self.smoothing > 0.0:
            target = target * (1 - self.smoothing) + self.smoothing / num_classes
        if self.target_threshold is not None:
            target = (target > self.target_threshold).to(x.dtype)
        return binary_cross_entropy_with_logits(x, target, reduction=self.reduction)

    def __to_config__(self):
        return dataclasses.asdict(self) | {"name": type(self).__name__}


@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss:
    """Softmax cross-entropy over the last axis with torch.nn.CrossEntropyLoss
    semantics: integer class labels, or class-probability targets of the
    logits' shape, and optional label smoothing; the criterion of the
    standard (non-B-cos) ViT baselines."""

    label_smoothing: float = 0.0
    reduction: str = "mean"

    def __call__(self, x, target):
        assert x.shape[0] == target.shape[0]
        s = self.label_smoothing
        if target.ndim == x.ndim:  # class-probability targets
            probs = target.to(x.dtype)
            if s > 0.0:
                probs = probs * (1 - s) + s / x.shape[-1]
            loss = -(probs * torch.log_softmax(x, dim=-1)).sum(-1)
        else:
            loss = cross_entropy(x, target, reduction="none")
            if s > 0.0:
                loss = (1 - s) * loss - s * torch.log_softmax(x, dim=-1).mean(-1)
        return _reduce(loss, self.reduction)

    def __to_config__(self):
        return dataclasses.asdict(self) | {"name": type(self).__name__}


@dataclasses.dataclass(frozen=True)
class UniformOffLabelsBCEWithLogitsLoss:
    """BCE with the off-labels raised to 1/num_classes (or ``off_label``):
    the B-cos training criterion."""

    reduction: str = "mean"
    off_label: Optional[float] = None

    def __call__(self, x, target):
        assert x.shape[0] == target.shape[0]
        off_value = self.off_label or (1.0 / x.shape[-1])
        target = torch.clamp(_one_hot_if_needed(x, target), min=off_value)
        return binary_cross_entropy_with_logits(x, target, reduction=self.reduction)

    def __to_config__(self):
        return dataclasses.asdict(self) | {"name": type(self).__name__}


@dataclasses.dataclass(frozen=True)
class SigLipLoss:
    """Sigmoid pairwise CLIP loss (SigLIP, arXiv 2303.15343), the criterion of
    the CLIP-KD recipe, in one process: -sum(log sigmoid(labels * logits)) /
    batch with labels +1 on the diagonal and -1 elsewhere.

    ``cos_scaling`` > 0 takes attn-unpool image features [HW, N, D]: the
    spatial logits are weighted by |logit|^(cos_scaling - 1) (detached in
    explanation mode) and averaged over the locations. ``world_size`` > 1,
    the ring exchange of the text features between processes, raises: it
    comes with port slice 8 (distribution)."""

    bidir: bool = True
    world_size: int = 1

    def get_ground_truth(self, dtype, device, num_logits: int, negative_only: bool):
        labels = -torch.ones((num_logits, num_logits), dtype=dtype, device=device)
        if not negative_only:
            labels = 2 * torch.eye(num_logits, dtype=dtype, device=device) + labels
        return labels

    def get_logits(self, image_features, text_features, logit_scale, logit_bias,
                   cos_scaling, explain):
        logits = image_features @ text_features.t()
        if cos_scaling > 0:
            w = torch.pow(logits, cos_scaling - 1).abs()
            if explain:
                w = w.detach()
            logits = (logits * w).mean(dim=0)
        if logit_scale is not None:
            logits = logit_scale * logits
        if logit_bias is not None:
            logits = logits + logit_bias
        return logits

    def __call__(self, image_features, text_features, logit_scale, logit_bias,
                 cos_scaling: int = 0, explain: bool = False):
        if self.world_size > 1:
            raise NotImplementedError(
                "SigLipLoss: the ring exchange across processes is not ported yet; it comes "
                "in port slice 8 (distribution)")
        logits = self.get_logits(image_features, text_features, logit_scale, logit_bias,
                                 cos_scaling, explain)
        batch = image_features.shape[1] if cos_scaling > 0 else image_features.shape[0]
        labels = self.get_ground_truth(image_features.dtype, image_features.device, batch,
                                       negative_only=False)
        return -F.logsigmoid(labels * logits).sum() / batch

    def __to_config__(self):
        return {"name": type(self).__name__, "bidir": self.bidir}
