"""Classification losses of the supervised recipe (counterpart of
``bcosification_tpu/losses.py``: ``binary_cross_entropy_with_logits``,
``BinaryCrossEntropyLoss`` and ``UniformOffLabelsBCEWithLogitsLoss``).

Targets are class indices [N] or dense [N, C]; dense targets of another
shape than the logits are one-hot encoded. The contrastive and KD losses
come with the CLIP slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "binary_cross_entropy_with_logits",
    "BinaryCrossEntropyLoss",
    "UniformOffLabelsBCEWithLogitsLoss",
]


def _one_hot_if_needed(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if target.shape != x.shape:
        target = F.one_hot(target.long(), x.shape[-1])
    return target.to(x.dtype)


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
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


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
