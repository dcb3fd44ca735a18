"""Text2Concept: align any vision model's features to CLIP text space with a
linear map, enabling zero-shot use of non-CLIP models.

Parity target: `CLIP_benchmark/clip_benchmark/models/
text2concept_clip.py` + `Text2Concept/TextToConcept.py` (Moayeri et al.,
"Text2Concept"): fit W s.t. W f(x) ~ clip_img(x) on an alignment set, then
classify with CLIP text embeddings against W f(x).

The reference's `LinearAligner.train` (TextToConcept.py:19-50) solves the
same linear regression by SGD (variance pre-scaling to target_variance=4.5,
momentum SGD with weight decay 5e-4 over 6 epochs, then W rescaled by
c1/c2); its released B-cos aligner is the no-bias variant
(text2concept_clip.py:43, "...noBiasLinearAligner.pth"). Here the regression
is solved in closed form (ridge least squares) — the INTENDED difference:
the normal equations give the same minimiser the reference's SGD
approximates, without the schedule/epoch hyperparameters; the differential
test (tests/test_text2concept.py) locks the agreement on a well-conditioned
synthetic problem against a faithful reimplementation of the reference's
SGD recipe. Aligner persistence mirrors `save_W`/`load_W`
(TextToConcept.py:52-75) with npz instead of torch.save; the npz is the
JAX package's, so one file serves both.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from bcosification_tpu_torch.clip_benchmark.models import features_numpy

__all__ = ["TextToConcept", "fit_linear_aligner"]


def fit_linear_aligner(
    F: np.ndarray, G: np.ndarray, ridge: float = 1e-2, bias: bool = False
):
    """Closed-form ridge least squares for W (and optionally b) minimising
    ||F W + b - G||^2 + ridge ||W||^2 — the regression the reference's
    `LinearRegressionSolver.train` runs by SGD (TextToConcept.py:92-137).
    Returns (W [d_in, d_out], b [d_out] or None)."""
    F = np.asarray(F, np.float64)
    G = np.asarray(G, np.float64)
    if bias:
        F1 = np.concatenate([F, np.ones((F.shape[0], 1))], axis=1)
        reg = ridge * np.eye(F1.shape[1])
        reg[-1, -1] = 0.0  # don't penalise the intercept
        Wb = np.linalg.solve(F1.T @ F1 + reg, F1.T @ G)
        return Wb[:-1].astype(np.float32), Wb[-1].astype(np.float32)
    A = F.T @ F + ridge * np.eye(F.shape[1])
    return np.linalg.solve(A, F.T @ G).astype(np.float32), None


class TextToConcept:
    def __init__(self, encode_features: Callable, clip_name: str = "RN50", *, device=None):
        """encode_features(images [B,H,W,C] tensor on ``device``) -> model
        features; the vanilla CLIP towers of ``clip_name`` are loaded on
        ``device`` (default the GPU)."""
        from bcosification_tpu_torch.clip.load import load as clip_load
        from bcosification_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.encode_features = encode_features
        self.clip_visual, self.text_model, _, self.cfg = clip_load(clip_name, device=self.device)
        self.W: Optional[np.ndarray] = None
        self.b: Optional[np.ndarray] = None

    def fit_aligner(
        self,
        loader,
        max_batches: int = 50,
        ridge: float = 1e-2,
        bias: bool = False,
    ):
        """Least-squares W: model-feature -> CLIP-image-embedding.

        ``bias=False`` matches the reference's released B-cos aligner (the
        noBias variant); ``bias=True`` matches the generic `LinearAligner`
        (TextToConcept.py:30 trains with bias and keeps it)."""
        from bcosification_tpu_torch.data.presets import CLIP_MEAN, CLIP_STD

        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=self.device)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=self.device)
        F, G = [], []
        with torch.no_grad():
            for i, batch in enumerate(loader):
                images = torch.as_tensor(np.asarray(
                    batch["image"] if isinstance(batch, dict) else batch[0], np.float32
                )).to(self.device)
                f = features_numpy(self.encode_features(images))
                if f.ndim == 3:
                    f = f.mean(axis=1)
                # CLIP tower expects raw [0,1] RGB; use the first 3 channels
                g = features_numpy(self.clip_visual((images[..., :3] - mean) / std))
                F.append(f)
                G.append(g)
                if i + 1 >= max_batches:
                    break
        self.W, self.b = fit_linear_aligner(
            np.concatenate(F), np.concatenate(G), ridge=ridge, bias=bias
        )
        return self

    def save_aligner(self, path: Union[str, Path]):
        """Persist W (and b when fitted with bias) — ≙ `LinearAligner.save_W`
        (TextToConcept.py:70-75), npz instead of torch.save."""
        assert self.W is not None, "call fit_aligner (or load_aligner) first"
        payload = {"W": self.W}
        if self.b is not None:
            payload["b"] = self.b
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **payload)
        return path

    def load_aligner(self, path: Union[str, Path]):
        """≙ `LinearAligner.load_W` (TextToConcept.py:57-68): the loader
        consumes a pretrained aligner file (text2concept_clip.py:43)."""
        with np.load(path) as data:
            self.W = np.asarray(data["W"], np.float32)
            self.b = (
                np.asarray(data["b"], np.float32) if "b" in data.files else None
            )
        return self

    def encode_image(self, images):
        """The model's features mapped into CLIP space: a tensor on the
        features' device."""
        assert self.W is not None, "call fit_aligner (or load_aligner) first"
        f = torch.as_tensor(self.encode_features(images))
        if f.ndim == 3:
            f = f.mean(dim=1)
        f = f.float()
        out = f @ torch.from_numpy(self.W).to(f.device)
        if self.b is not None:
            out = out + torch.from_numpy(self.b).to(f.device)
        return out

    def zero_shot_classifier(self, classnames, templates):
        from bcosification_tpu_torch.training.zeroshot import zeroshot_classifier

        return zeroshot_classifier(self.text_model, classnames, templates)
