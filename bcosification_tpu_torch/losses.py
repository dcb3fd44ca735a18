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

The reference's other contrastive losses, in their one-process forms:
``info_nce`` / ``InfoNCELoss``, open_clip's ``ClipLoss``, ``CoCaLoss`` and
``DistillClipLoss``. Their gathers across processes (``gather_features``,
``neighbour_exchange``, ``neighbour_exchange_bidir``, a ``world_size`` > 1)
raise: they come with ROADMAP A9.
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
    "info_nce",
    "InfoNCELoss",
    "gather_features",
    "neighbour_exchange",
    "neighbour_exchange_bidir",
    "ClipLoss",
    "CoCaLoss",
    "DistillClipLoss",
]

_SLICE_A9 = "ROADMAP A9 (port slice 8, distribution)"


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean",
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """Softmax cross-entropy with integer labels over the last axis; labels
    equal to ``ignore_index`` count 0, and the mean is over the others."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]
    if ignore_index is not None:
        mask = (labels != ignore_index).to(nll.dtype)
        nll = nll * mask
        if reduction == "mean":
            return nll.sum() / torch.clamp(mask.sum(), min=1)
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


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def info_nce(query, positive_key, negative_keys=None, temperature: float = 0.1,
             reduction: str = "mean", negative_mode: str = "unpaired") -> torch.Tensor:
    """Contrastive InfoNCE on L2-normalised features: with ``negative_keys``
    ([M, D] "unpaired" or [N, M, D] "paired") the positive is class 0 of
    [positive, negatives]; without them the other rows of the batch are
    the negatives."""
    query, positive_key = _l2_normalize(query), _l2_normalize(positive_key)
    if negative_keys is not None:
        negative_keys = _l2_normalize(negative_keys)
        positive_logit = (query * positive_key).sum(dim=1, keepdim=True)
        if negative_mode == "unpaired":
            negative_logits = query @ negative_keys.t()
        elif negative_mode == "paired":
            negative_logits = torch.einsum("nd,nmd->nm", query, negative_keys)
        else:
            raise ValueError(negative_mode)
        logits = torch.cat([positive_logit, negative_logits], dim=1)
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    else:
        logits = query @ positive_key.t()
        labels = torch.arange(query.shape[0], device=query.device)
    return cross_entropy(logits / temperature, labels, reduction=reduction)


@dataclasses.dataclass(frozen=True)
class InfoNCELoss:
    temperature: float = 0.1
    reduction: str = "mean"
    negative_mode: str = "unpaired"

    def __call__(self, query, positive_key, negative_keys=None):
        return info_nce(query, positive_key, negative_keys, temperature=self.temperature,
                        reduction=self.reduction, negative_mode=self.negative_mode)


def gather_features(image_features, text_features, *args, **kwargs):
    """The gather of contrastive features across processes: not ported."""
    raise NotImplementedError(f"gather_features needs a process group; it comes in {_SLICE_A9}")


def neighbour_exchange(tensor, *args, **kwargs):
    """One hop around the ring of processes: not ported."""
    raise NotImplementedError(f"neighbour_exchange needs a process group; it comes in "
                              f"{_SLICE_A9}")


def neighbour_exchange_bidir(tensor_to_left, tensor_to_right, *args, **kwargs):
    """The bidirectional ring hop: not ported."""
    raise NotImplementedError(f"neighbour_exchange_bidir needs a process group; it comes in "
                              f"{_SLICE_A9}")


@dataclasses.dataclass(frozen=True)
class ClipLoss:
    """open_clip's contrastive loss in one process: the mean of the image-
    and text-side cross-entropies of ``logit_scale`` times the feature
    products, the matching pairs on the diagonal. ``world_size`` > 1 (the
    gathered features of every process) raises."""

    local_loss: bool = False
    world_size: int = 1

    def get_logits(self, image_features, text_features, logit_scale):
        if self.world_size > 1:
            gather_features(image_features, text_features)
        return (logit_scale * image_features @ text_features.t(),
                logit_scale * text_features @ image_features.t())

    def get_ground_truth(self, num_logits: int, device) -> torch.Tensor:
        return torch.arange(num_logits, device=device)

    def __call__(self, image_features, text_features, logit_scale):
        lpi, lpt = self.get_logits(image_features, text_features, logit_scale)
        labels = self.get_ground_truth(lpi.shape[0], lpi.device)
        return (cross_entropy(lpi, labels) + cross_entropy(lpt, labels)) / 2


@dataclasses.dataclass(frozen=True)
class CoCaLoss(ClipLoss):
    """CoCa: (the weighted contrastive loss, the weighted captioning
    cross-entropy with ``pad_id`` ignored)."""

    caption_loss_weight: float = 1.0
    clip_loss_weight: float = 1.0
    pad_id: int = 0

    def __call__(self, image_features, text_features, logits, labels, logit_scale):
        clip_loss = torch.zeros((), device=logits.device)
        if self.clip_loss_weight:
            clip_loss = self.clip_loss_weight * ClipLoss.__call__(
                self, image_features, text_features, logit_scale)
        caption_loss = self.caption_loss_weight * cross_entropy(logits, labels,
                                                                ignore_index=self.pad_id)
        return clip_loss, caption_loss


@dataclasses.dataclass(frozen=True)
class DistillClipLoss(ClipLoss):
    """CLIP distillation: (the contrastive loss of the student, the
    cross-entropy of the student's logits against the teacher's softmax)."""

    def dist_loss(self, teacher_logits, student_logits):
        return -(torch.softmax(teacher_logits, dim=1)
                 * torch.log_softmax(student_logits, dim=1)).sum(dim=1).mean()

    def __call__(self, image_features, text_features, logit_scale, dist_image_features,
                 dist_text_features, dist_logit_scale):
        lpi, lpt = self.get_logits(image_features, text_features, logit_scale)
        dlpi, dlpt = self.get_logits(dist_image_features, dist_text_features, dist_logit_scale)
        labels = self.get_ground_truth(lpi.shape[0], lpi.device)
        contrastive = (cross_entropy(lpi, labels) + cross_entropy(lpt, labels)) / 2
        distill = (self.dist_loss(dlpi, lpi) + self.dist_loss(dlpt, lpt)) / 2
        return contrastive, distill
