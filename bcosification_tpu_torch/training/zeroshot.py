"""CLIP zero-shot classification (counterpart of
``bcosification_tpu/training/zeroshot.py``).

The classifier is the prompt ensemble of the CLIP text tower: per class,
the features of every template, each L2-normalised, averaged and
normalised again -> [D, C]. Logits are 100 * x_hat @ W; attn-unpool
features [B, HW, D] are weighted by |logit|^(cos_power - 1) (detached) and
summed over the locations, as the reference's trainer does.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch

from bcosification_tpu_torch.clip.tokenizer import tokenize

__all__ = [
    "format_template",
    "zeroshot_classifier",
    "zeroshot_predict_logits",
    "zeroshot_evaluate",
    "save_zeroshot_weights",
    "load_zeroshot_weights",
]


def format_template(template: str, classname: str) -> str:
    """A prompt template for a class: CLIP_benchmark's named ``{c}``
    placeholder or the OpenAI ImageNet templates' bare ``{}``."""
    if "{c}" in template:
        return template.format(c=classname)
    return template.format(classname)


def save_zeroshot_weights(path: str, weights) -> None:
    """Save a [D, C] zero-shot classifier as a float32 .npy."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    np.save(path, np.asarray(weights, dtype=np.float32), allow_pickle=False)


def load_zeroshot_weights(path: str) -> torch.Tensor:
    """A precomputed [D, C] classifier: .npy / .npz (one array) or a saved
    torch tensor (the reference's format)."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path, allow_pickle=False)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        w = torch.from_numpy(np.asarray(arr, dtype=np.float32))
    else:
        w = torch.load(path, map_location="cpu", weights_only=True).detach().float()
    if w.dim() != 2:
        raise ValueError(f"zeroshot weights must be [D, C], got shape {tuple(w.shape)}")
    return w


def zeroshot_classifier(text_model, classnames: Sequence[str], templates: Sequence[str],
                        batch_classes: int = 32) -> torch.Tensor:
    """[D, n_classes] f32 prompt-ensembled zero-shot weights of the text tower
    ``text_model``, on its device; ``batch_classes`` classes (each with all
    its templates) per call of the tower."""
    weights = []
    with torch.no_grad():
        for start in range(0, len(classnames), batch_classes):
            chunk = classnames[start:start + batch_classes]
            texts = [format_template(t, c) for c in chunk for t in templates]
            emb = text_model(tokenize(texts)).float()  # [n_chunk * n_templ, D]
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb = emb.reshape(len(chunk), len(templates), -1).mean(dim=1)
            weights.append(emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True))
    return torch.cat(weights, dim=0).t()


def zeroshot_predict_logits(image_features: torch.Tensor, zeroshot_weights: torch.Tensor,
                            cos_power: int = 0) -> torch.Tensor:
    """100 * x_hat @ W; attn-unpool features [B, HW, D] are cosine-power
    weighted and summed over the locations."""
    feats = image_features / torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
    logits = 100.0 * feats @ zeroshot_weights.to(feats.dtype)
    if logits.dim() == 3:
        p = max(cos_power, 1)
        logits = (logits * logits.detach().abs() ** (p - 1)).sum(dim=1)
    return logits


def zeroshot_evaluate(image_encode: Callable[[torch.Tensor], torch.Tensor], loader: Iterable,
                      zeroshot_weights: torch.Tensor, cos_power: int = 0) -> Dict[str, float]:
    """Top-1/5 zero-shot accuracy over a loader of {"image", "label"}
    batches; ``image_encode`` maps a batch of images (on the weights'
    device) to features."""
    top1 = top5 = n = 0
    dev = zeroshot_weights.device
    with torch.no_grad():
        for batch in loader:
            images = torch.as_tensor(batch["image"]).to(dev)
            target = np.asarray(batch["label"])
            if target.ndim > 1:  # dense / one-hot labels
                target = np.argmax(target, axis=-1)
            logits = zeroshot_predict_logits(image_encode(images), zeroshot_weights, cos_power)
            pred5 = torch.topk(logits.float(), 5, dim=-1).indices.cpu().numpy()
            top1 += int((pred5[:, 0] == target).sum())
            top5 += int((pred5 == target[:, None]).any(axis=1).sum())
            n += len(target)
    return {"acc1": top1 / max(n, 1), "acc5": top5 / max(n, 1)}
