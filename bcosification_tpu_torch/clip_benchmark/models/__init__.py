"""Model loaders for the benchmark CLI (the port's counterpart of the JAX
package's ``clip_benchmark/models/__init__.py``).

Parity target: `CLIP_benchmark/clip_benchmark/models/__init__.py` +
`bcos_clip.py` / `bcos_clip_cc3m.py` / `standard_clip.py`:
`load_clip(model_type, ...) -> (model_bundle, transform, tokenizer)`.

The bundle interface consumed by the metrics:
- encode_image(images [B,H,W,C] tensor on ``bundle.device``) -> features
  (a tensor on the device; the external torch bundles return numpy);
- encode_texts(list[str]) -> numpy features of the text tower, which stays
  resident on the device (B-cos image-only models fall back to the vanilla
  CLIP RN50 text tower, the reference's behaviour at
  `metrics/zeroshot_classification.py:54-58`).

Every encoder runs eagerly on ``device`` (default the GPU, which raises when
there is none; ``"cpu"`` runs the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import os
import re
import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from bcosification_tpu_torch.device import resolve_device

MODEL_TYPES = [
    "open_clip",
    "standard_clip",
    "bcos_clip",
    "bcos_clip_cc3m",
    "bcos_captioner",
    "text2concept_clip",
    "ja_clip",
    "nllb_clip",
]

__all__ = ["MODEL_TYPES", "load_clip", "ModelBundle", "features_numpy"]

# the CLIP ViT towers are not in the port yet (clip/model.py raises)
CLIP_VIT_ITEM = "ROADMAP A6 (the CLIP ViT towers)"


def features_numpy(feats) -> np.ndarray:
    """A feature batch (tensor on any device, or numpy) as float32 numpy."""
    if isinstance(feats, torch.Tensor):
        return feats.detach().float().cpu().numpy()
    return np.asarray(feats, np.float32)


@dataclasses.dataclass
class ModelBundle:
    encode_image: Callable
    text_model: Any
    tokenizer: Callable
    cosine_power: int = 0
    device: torch.device = torch.device("cpu")
    # external torch bundles: a direct numpy text encoder instead of
    # tokenizer + text_model
    encode_texts_fn: Optional[Callable] = None

    def images(self, images) -> torch.Tensor:
        """A loader's image batch (numpy or a tensor) as a float32 tensor on
        the device."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images, np.float32))
        return images.to(self.device, torch.float32)

    def encode_texts(self, texts: List[str], batch: int = 256) -> np.ndarray:
        outs = []
        for i in range(0, len(texts), batch):
            chunk = list(texts[i : i + batch])
            if self.encode_texts_fn is not None:
                outs.append(features_numpy(self.encode_texts_fn(chunk)))
                continue
            tokens = torch.from_numpy(np.asarray(self.tokenizer(chunk))).to(self.device)
            with torch.no_grad():
                outs.append(features_numpy(self.text_model(tokens)))
        return np.concatenate(outs)


def _clip_eval_transform(n_px: int = 224, normalize: bool = False):
    from bcosification_tpu_torch.data import transforms as T
    from bcosification_tpu_torch.data.presets import CLIP_MEAN, CLIP_STD

    trans = [T.Resize(n_px, interpolation="bicubic"), T.CenterCrop(n_px), T.ToFloatArray()]
    if normalize:
        trans.append(T.Normalize(CLIP_MEAN, CLIP_STD))
    return T.Compose(trans)


def _addinverse_transform(n_px: int = 224):
    from bcosification_tpu_torch.data import transforms as T

    return T.Compose(
        [T.Resize(n_px), T.CenterCrop(n_px), T.ToFloatArray(), T.AddInverse()]
    )


def _eager(module: torch.nn.Module) -> Callable:
    def encode(images):
        with torch.no_grad():
            return module(images)

    return encode


def _load_bcos_clip(model_name: str, pretrained: str, experiment_path: Optional[str],
                    dataset_dir: str = "clip_bcosification", device=None):
    """models/bcos_clip.py:20-39: Experiment under
    experiments/<dataset>/clip_bcosification/ at its best checkpoint (else
    its conversion-time init), AddInverse transform, clip.tokenize;
    attn-unpool variants read cosine_power from `pretrained`. The tower is
    ``bundle.image_model``."""
    from bcosification_tpu_torch.clip.load import load as clip_load
    from bcosification_tpu_torch.clip.tokenizer import tokenize
    from bcosification_tpu_torch.experiments.utils import Experiment

    dev = resolve_device(device)
    dataset = "CC3M" if dataset_dir == "clip_bcosification_cc3m" else "ImageNet"
    if experiment_path:
        experiment = Experiment(path=experiment_path)
    else:
        experiment = Experiment(dataset, "clip_bcosification", model_name)
    try:
        model = experiment.load_trained_model("best_any", device=dev)
    except FileNotFoundError:
        print("No trained checkpoint; using conversion-time init")
        model = experiment.get_model(device=dev)

    cosine_power = 0
    if experiment.config.get("model", {}).get("attn_unpool", False):
        try:
            cosine_power = int(pretrained)
        except (TypeError, ValueError):
            cosine_power = int(experiment.config["model"].get("cos_power", 1))

    # text tower fallback: vanilla CLIP RN50
    _, text_model, _, _ = clip_load("RN50", device=dev)
    bundle = ModelBundle(_eager(model), text_model, tokenize, cosine_power, dev)
    bundle.image_model = model
    return bundle, _addinverse_transform(), tokenize


def _load_bcos_captioner(model_name: str, pretrained: str, experiment_path: Optional[str],
                         device=None):
    """The in-framework generative bundle for `--task captioning`: a B-cos
    CLIP image tower + the greedy caption head (models/captioner.py).
    ``pretrained`` may name an .npz of the head's named arrays
    (``captioner.save_captioner``; a flax head converts through
    ``captioner.captioner_from_jax``); otherwise the head is at random init
    from seed 0 (the task still runs end-to-end, mirroring the reference's
    untrained-model fallback behaviour)."""
    from bcosification_tpu_torch.models import captioner as cap_lib

    bundle, transform, tok = _load_bcos_clip(model_name, "", experiment_path, device=device)
    if pretrained and pretrained.endswith(".npz"):
        head = cap_lib.load_captioner(pretrained, device=bundle.device)
    else:
        feature_dim = bundle.image_model.model.attnpool.c_proj.weight.shape[-1]
        head = cap_lib.GreedyCaptioner(feature_dim, vocab_size=49408, device=bundle.device)

    def generate(images) -> List[str]:
        with torch.no_grad():
            feats = bundle.encode_image(bundle.images(images))
            if feats.ndim == 3:  # attn-unpool spatial features -> mean-pool
                feats = feats.mean(dim=1)
            tokens = cap_lib.greedy_generate(head, feats.float())
        return cap_lib.decode_tokens(tokens.cpu().numpy(), eos=head.eos)

    bundle.generate = generate
    bundle.caption_head = head
    return bundle, transform, tok


def _load_standard_clip(model_name: str, pretrained: str, device=None):
    from bcosification_tpu_torch.clip.load import available_models
    from bcosification_tpu_torch.clip.load import load as clip_load
    from bcosification_tpu_torch.clip.tokenizer import tokenize

    # resolve benchmark-style names ("ViT-B-32") to OpenAI tower names
    # ("ViT-B/32"); only genuinely unknown names fall back to RN50, loudly
    name = model_name
    available = available_models()
    if name not in available:
        alt = re.sub(r"^(ViT-[A-Za-z]+)-(\d+.*)$", r"\1/\2", name)
        if alt in available:
            name = alt
        else:
            warnings.warn(
                f"standard_clip: unknown model {model_name!r}; "
                f"falling back to RN50 (available: {available})"
            )
            name = "RN50"
    if name.startswith("ViT"):
        raise NotImplementedError(
            f"standard_clip {model_name!r}: the port has no CLIP ViT tower yet; it comes "
            f"with {CLIP_VIT_ITEM}")
    dev = resolve_device(device)
    visual, text_model, _, cfg = clip_load(name, device=dev)
    bundle = ModelBundle(_eager(visual), text_model, tokenize, 0, dev)
    return bundle, _clip_eval_transform(cfg["image_resolution"], normalize=True), tokenize


def load_clip(
    model_type: str = "standard_clip",
    model_name: str = "RN50",
    pretrained: str = "",
    cache_dir: Optional[str] = None,
    device=None,
    cosine_power: int = 1,
    experiment_path: Optional[str] = None,
):
    """(bundle, transform, tokenizer) of ``model_type`` on ``device``
    (default the GPU)."""
    if model_type == "bcos_clip":
        return _load_bcos_clip(model_name, pretrained, experiment_path, device=device)
    if model_type == "bcos_clip_cc3m":
        return _load_bcos_clip(model_name, pretrained, experiment_path,
                               dataset_dir="clip_bcosification_cc3m", device=device)
    if model_type == "standard_clip":
        return _load_standard_clip(model_name, pretrained, device=device)
    if model_type == "bcos_captioner":
        return _load_bcos_captioner(model_name, pretrained, experiment_path, device=device)
    if model_type == "text2concept_clip":
        # align a (B-cos) vision model's features into CLIP space. When
        # ``pretrained`` points to a saved aligner npz (containing "W"), it
        # is loaded — ≙ the reference loader consuming a pretrained aligner
        # file (ref models/text2concept_clip.py:43); otherwise the caller
        # must fit_aligner on an alignment set.
        aligner_path = None
        if pretrained and pretrained.endswith(".npz") and os.path.exists(pretrained):
            with np.load(pretrained) as data:
                if "W" in data.files:
                    aligner_path = pretrained
        bundle, transform, tok = _load_bcos_clip(
            model_name, "" if aligner_path else pretrained, experiment_path, device=device
        )
        from bcosification_tpu_torch.clip_benchmark.models.text2concept import TextToConcept

        t2c = TextToConcept(bundle.encode_image, device=bundle.device)
        if aligner_path:
            t2c.load_aligner(aligner_path)
        bundle = ModelBundle(t2c.encode_image, t2c.text_model, tok, bundle.cosine_power,
                             bundle.device)
        bundle.text2concept = t2c
        return bundle, transform, tok
    dev = str(resolve_device(device))
    if model_type == "open_clip":
        from bcosification_tpu_torch.clip_benchmark.models.open_clip import load_open_clip

        return load_open_clip(model_name, pretrained, device=dev, cache_dir=cache_dir)
    if model_type == "ja_clip":
        from bcosification_tpu_torch.clip_benchmark.models.japanese_clip import (
            load_japanese_clip,
        )

        return load_japanese_clip(pretrained, device=dev, cache_dir=cache_dir)
    if model_type == "nllb_clip":
        from bcosification_tpu_torch.clip_benchmark.models.nllb_clip import load_nllb_clip

        return load_nllb_clip(model_name, pretrained, device=dev, cache_dir=cache_dir)
    raise ValueError(f"unknown model_type {model_type!r}")
