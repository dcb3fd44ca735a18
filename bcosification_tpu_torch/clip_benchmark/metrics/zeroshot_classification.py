"""Zero-shot classification metric.

Parity target: `CLIP_benchmark/clip_benchmark/metrics/
zeroshot_classification.py`: prompt-ensembled text classifier (normalise-mean-
normalise per class, :15-63), image loop `logits = 100 * x_hat @ W` with the
B-cos fallback (models without `encode_image` are called directly, :120-124)
and the attn-unpool cosine_power path (:129-134); acc1/acc5 + mean-per-class
recall (balanced accuracy), multilabel mAP (:143-181).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["zero_shot_classifier", "run_classification", "evaluate", "average_precision"]


def zero_shot_classifier(model_bundle, classnames, templates, batch_classes: int = 16):
    """Build [D, C] zeroshot weights: per class, embed its prompts, normalise,
    mean, normalise (reference zeroshot_classification.py:15-63). Template
    handling is reference-exact: a dict maps classname -> class-specific
    prompt list (CuPL), a list holds generic templates specialised per class
    (named ``{c}`` or bare ``{}`` placeholders, see
    training.zeroshot.format_template). Routed through
    ``model_bundle.encode_texts`` so the port's text towers and external
    torch bundles (ja_clip/nllb_clip/open_clip) share the path. The text
    tower stays resident on the bundle's device: nothing is rebuilt per
    class. Returns float32 numpy."""
    from bcosification_tpu_torch.training.zeroshot import format_template

    weights = []
    for c in classnames:
        if isinstance(templates, dict):
            texts = list(templates[c])
        elif isinstance(templates, (list, tuple)):
            texts = [format_template(t, c) for t in templates]
        else:
            raise ValueError("templates must be a list or a dict")
        emb = np.asarray(model_bundle.encode_texts(texts))
        emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        emb = emb.mean(axis=0)
        weights.append(emb / np.linalg.norm(emb))
    return np.stack(weights, axis=1)  # [D, C]


def run_classification(model_bundle, classifier, loader, cosine_power: int = 0):
    """-> (logits [N, C], targets [N]) as numpy: each batch encoded and
    classified on the bundle's device
    (``training.zeroshot.zeroshot_predict_logits``)."""
    from bcosification_tpu_torch.training.zeroshot import zeroshot_predict_logits

    weights = torch.as_tensor(np.asarray(classifier, np.float32)).to(model_bundle.device)
    all_logits, all_targets = [], []
    with torch.no_grad():
        for batch in loader:
            images, target = batch if isinstance(batch, (tuple, list)) else (
                batch["image"],
                batch["label"],
            )
            feats = torch.as_tensor(
                model_bundle.encode_image(model_bundle.images(images))
            ).to(model_bundle.device)
            logits = zeroshot_predict_logits(feats, weights, cosine_power)
            all_logits.append(logits.float().cpu().numpy())
            all_targets.append(np.asarray(target))
    return np.concatenate(all_logits), np.concatenate(all_targets)


def accuracy(logits: np.ndarray, target: np.ndarray, topk=(1,)) -> List[float]:
    pred = np.argsort(-logits, axis=-1)
    return [
        float((pred[:, :k] == target[:, None]).any(axis=1).mean()) for k in topk
    ]


def mean_per_class_recall(logits: np.ndarray, target: np.ndarray) -> float:
    pred = logits.argmax(axis=-1)
    recalls = []
    for c in np.unique(target):
        mask = target == c
        recalls.append(float((pred[mask] == c).mean()))
    return float(np.mean(recalls))


def average_precision(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-class AP for multilabel eval (VOC-style)."""
    aps = []
    for c in range(scores.shape[1]):
        s, t = scores[:, c], targets[:, c]
        order = np.argsort(-s)
        t = t[order]
        tp = np.cumsum(t)
        precision = tp / (np.arange(len(t)) + 1)
        n_pos = t.sum()
        ap = (precision * t).sum() / max(n_pos, 1)
        aps.append(float(ap))
    return np.asarray(aps)


def evaluate(
    model_bundle,
    loader,
    classnames: Sequence[str],
    templates: Sequence[str],
    cosine_power: int = 0,
    verbose: bool = False,
    save_clf: Optional[str] = None,
    load_clfs: Sequence[str] = (),
) -> Dict[str, float]:
    if load_clfs:
        # reference :215-219: plain mean of the loaded classifiers, NOT
        # renormalised per class column
        clfs = [np.load(p) for p in load_clfs]
        classifier = np.mean(clfs, axis=0)
    else:
        classifier = zero_shot_classifier(model_bundle, classnames, templates)
    if save_clf is not None:
        np.save(save_clf, classifier)
    logits, target = run_classification(
        model_bundle, classifier, loader, cosine_power
    )
    if target.ndim == 2:  # multilabel
        ap = average_precision(logits, target)
        return {"mean_average_precision": float(ap.mean())}
    if len(classnames) >= 5:
        acc1, acc5 = accuracy(logits, target, topk=(1, 5))
    else:
        # reference :245-248: top-5 is meaningless with < 5 classes
        (acc1,) = accuracy(logits, target, topk=(1,))
        acc5 = float("nan")
    return {
        "acc1": acc1,
        "acc5": acc5,
        "mean_per_class_recall": mean_per_class_recall(logits, target),
    }
