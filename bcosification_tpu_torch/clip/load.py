"""Resolve an OpenAI CLIP checkpoint from local files and build its towers
(counterpart of ``bcosification_tpu/clip/load.py``).

A checkpoint is read from ``$CLIP_WEIGHTS_PATH`` (one file), from
``$CLIP_WEIGHTS_DIR/<name>.{pt,pth,npz}`` (``/`` in the name becomes
``-``: ``ViT-B-32.pt``), or from the JAX package's download cache
(``~/.cache/bcosification_tpu/clip/<name>.pt``, checked against the
published sha256). OpenAI ships TorchScript archives, read with
``torch.jit.load``; a ``.pth`` is a pickled state dict (read with
``weights_only=True``) and an ``.npz`` holds the arrays. Tensors come back
as float32 numpy arrays.

Nothing is downloaded. Without a file the caller gets None and a warning
(random init); with ``BCOS_ALLOW_DOWNLOAD=1``, which asks the JAX package
to fetch the file, the port raises and names the file to put in place.
"""
from __future__ import annotations

import hashlib
import os
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from bcosification_tpu_torch.clip import model as clip_model
from bcosification_tpu_torch.clip.tokenizer import tokenize  # noqa: F401  (re-export)

__all__ = ["MODEL_CONFIG_CLIP_NAMES", "available_models", "load_state_dict_file", "load",
           "tokenize"]

_MODELS = ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64", "ViT-B/32", "ViT-B/16", "ViT-L/14"]
# sha256 of OpenAI's published checkpoints (the second-to-last component of
# their release URLs), against which the download cache is checked
_MODEL_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "RN50x64": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
    "ViT-L/14": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836",
}

# the experiments' model names -> OpenAI CLIP tower names
MODEL_CONFIG_CLIP_NAMES = {
    "resnet50clip": "RN50",
    "vitb32clip": "ViT-B/32",
    "vitb16clip": "ViT-B/16",
    "vitl14clip": "ViT-L/14",
}


def available_models():
    return list(_MODELS)


def _file_name(name: str) -> str:
    return name.replace("/", "-")


def _cache_file(name: str) -> Path:
    return Path.home() / ".cache" / "bcosification_tpu" / "clip" / f"{_file_name(name)}.pt"


def _maybe_fetch_checkpoint(name: str) -> None:
    """The JAX package downloads the checkpoint when BCOS_ALLOW_DOWNLOAD=1;
    the port has no network path, so it raises then and names the file.
    Otherwise it returns None (random init, as the JAX package without the
    gate)."""
    if os.getenv("BCOS_ALLOW_DOWNLOAD", "0") == "1":
        raise RuntimeError(
            f"the PyTorch port has no network path: put the CLIP checkpoint {name!r} at "
            f"$CLIP_WEIGHTS_DIR/{_file_name(name)}.pt (or name the file in "
            "$CLIP_WEIGHTS_PATH)")
    return None


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def _read_state_dict(path: Path) -> Dict[str, np.ndarray]:
    if path.suffix == ".npz":
        with np.load(path) as loaded:  # plain arrays only: never allow_pickle
            return {k: np.asarray(loaded[k], np.float32) for k in loaded.files}
    try:
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive: a pickled state dict
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.float().numpy() for k, v in sd.items()
            if k not in ("input_resolution", "context_length", "vocab_size")}


def load_state_dict_file(name: str = "RN50") -> Optional[Dict[str, np.ndarray]]:
    """The OpenAI CLIP checkpoint ``name`` as {key: float32 array}, or None
    (with a warning) when no local file holds it."""
    candidates = []
    if os.getenv("CLIP_WEIGHTS_PATH"):
        candidates.append(Path(os.environ["CLIP_WEIGHTS_PATH"]))
    if os.getenv("CLIP_WEIGHTS_DIR"):
        candidates += [Path(os.environ["CLIP_WEIGHTS_DIR"]) / f"{_file_name(name)}{ext}"
                       for ext in (".pt", ".pth", ".npz")]
    cache = _cache_file(name)
    candidates.append(cache)
    path = next((p for p in candidates if p.exists()), None)
    if path == cache and name in _MODEL_SHA256 and _sha256(path) != _MODEL_SHA256[name]:
        warnings.warn(f"{path} fails its sha256 check")
        path = None
    if path is None:
        _maybe_fetch_checkpoint(name)
        warnings.warn(
            f"No CLIP checkpoint for {name!r} (set CLIP_WEIGHTS_PATH or "
            "CLIP_WEIGHTS_DIR); using random init.")
        return None
    return _read_state_dict(path)


def load(name: str = "RN50", pretrained: bool = True, *, device=None):
    """(visual, text, logit_scale, cfg): the frozen teacher tower and the text
    tower of ``name`` in eval mode on ``device`` (default the GPU), from the
    checkpoint when ``pretrained`` and one is found, else at random init."""
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_clip_teacher_visual,
        build_clip_text,
    )

    sd = load_state_dict_file(name) if pretrained else None
    if sd is not None:
        cfg = clip_model.config_from_state_dict(sd)
    elif name.startswith("ViT"):
        cfg = clip_model.clip_vit_config(name)
    else:
        cfg = clip_model.clip_rn50_config()
    visual = build_clip_teacher_visual(sd, cfg, device=device)
    text = build_clip_text(sd, cfg, device=device)
    logit_scale = float(np.exp(sd["logit_scale"])) if sd is not None else float(1 / 0.07)
    return visual, text, logit_scale, cfg
