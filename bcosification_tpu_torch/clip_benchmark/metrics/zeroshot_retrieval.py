"""Image-text retrieval metric (recall@K).

Parity target: `CLIP_benchmark/clip_benchmark/metrics/
zeroshot_retrieval.py`: encode all images and all captions, recall@K in both
directions with the multi-caption positive-pair bookkeeping. The encoders
run on the bundle's device; the scores, argsorts and recalls in numpy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bcosification_tpu_torch.clip_benchmark.models import features_numpy

__all__ = ["evaluate"]


def evaluate(model_bundle, loader, recall_k_list: Sequence[int] = (5,)) -> Dict[str, float]:
    img_feats: List[np.ndarray] = []
    captions: List[str] = []
    img_of_caption: List[int] = []
    for batch in loader:
        images, caps_batch = batch
        with torch.no_grad():
            feats = features_numpy(model_bundle.encode_image(model_bundle.images(images)))
        if feats.ndim == 3:
            feats = feats.mean(axis=1)
        for i, caps in enumerate(caps_batch):
            idx = len(img_feats) + i
            caps = caps if isinstance(caps, (list, tuple)) else [caps]
            for c in caps:
                captions.append(c)
                img_of_caption.append(idx)
        img_feats.extend(feats)
    img = np.stack(img_feats)
    txt = np.asarray(model_bundle.encode_texts(captions))

    img = img / np.linalg.norm(img, axis=-1, keepdims=True)
    txt = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
    scores = txt @ img.T  # [n_captions, n_images]
    img_of_caption_arr = np.asarray(img_of_caption)

    metrics: Dict[str, float] = {}
    for k in recall_k_list:
        # naming follows the reference (zeroshot_retrieval.py:85-87): the key
        # says what is RETRIEVED — image_retrieval = top-k images per caption,
        # text_retrieval = top-k captions per image — locked by
        # tests/test_clip_benchmark_parity.py (the symmetric-fixture exact
        # test cannot distinguish the directions)
        topk_img = np.argsort(-scores, axis=1)[:, :k]
        t2i = float((topk_img == img_of_caption_arr[:, None]).any(axis=1).mean())
        topk_txt = np.argsort(-scores.T, axis=1)[:, :k]
        i2t = float(
            np.mean(
                [
                    np.isin(topk_txt[i], np.where(img_of_caption_arr == i)[0]).any()
                    for i in range(img.shape[0])
                ]
            )
        )
        metrics[f"image_retrieval_recall@{k}"] = t2i
        metrics[f"text_retrieval_recall@{k}"] = i2t
    return metrics
