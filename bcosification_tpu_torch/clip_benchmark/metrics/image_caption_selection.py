"""Image-caption selection metric (Winoground/SugarCrepe-style).

Parity target: `CLIP_benchmark/clip_benchmark/metrics/
image_caption_selection.py`: each instance has I images and C candidate
captions; the i-th image must match the i-th caption in BOTH directions
(per-image argmax over captions AND per-caption argmax over images, over the
leading min(I, C) pairs). Returns the reference's three keys: ``image_acc``
(all captions pick their image), ``text_acc`` (all images pick their
caption), ``acc`` (both). Locked against the reference implementation by
tests/test_clip_benchmark_parity.py.

For the SugarCrepe-style single-image case (images [B, H, W, C], captions
[positive, distractors...]) ``text_acc`` reduces to "the positive caption
wins", and ``image_acc`` is trivially 1. The encoders run on the bundle's
device; the scores and argmaxes in numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bcosification_tpu_torch.clip_benchmark.models import features_numpy

__all__ = ["evaluate"]


def evaluate(model_bundle, loader) -> Dict[str, float]:
    image_score, text_score, score = [], [], []
    for batch in loader:
        images, caps_batch = batch
        images = np.asarray(images)
        if images.ndim == 4:  # [B, H, W, C] -> one image per instance
            images = images[:, None]
        b, nim = images.shape[:2]
        with torch.no_grad():
            feats = features_numpy(model_bundle.encode_image(
                model_bundle.images(images.reshape(b * nim, *images.shape[2:]))))
        if feats.ndim == 3:
            feats = feats.mean(axis=1)
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        feats = feats.reshape(b, nim, -1)
        for i, caps in enumerate(caps_batch):
            caps = list(caps) if isinstance(caps, (list, tuple)) else [caps]
            txt = np.asarray(model_bundle.encode_texts(caps))
            txt = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
            # scores [nim, ncaps]; the i-th image must pair with the i-th
            # caption (ref :60-74)
            scores = feats[i] @ txt.T
            n = min(nim, len(caps))
            text_ok = bool((scores.argmax(axis=1)[:n] == np.arange(n)).all())
            image_ok = bool((scores.argmax(axis=0)[:n] == np.arange(n)).all())
            text_score.append(text_ok)
            image_score.append(image_ok)
            score.append(text_ok and image_ok)
    return {
        "image_acc": float(np.mean(image_score)) if image_score else 0.0,
        "text_acc": float(np.mean(text_score)) if text_score else 0.0,
        "acc": float(np.mean(score)) if score else 0.0,
    }
