"""open_clip loader (import-gated).

Parity target: `CLIP_benchmark/clip_benchmark/models/
open_clip.py` — create_model_and_transforms + get_tokenizer, wrapped into the
benchmark bundle. The adapters convert at the numpy boundary. Also the
carrier for NLLB-CLIP models (see nllb_clip.py).
"""
from __future__ import annotations

import numpy as np

from bcosification_tpu_torch.clip_benchmark.models.torch_adapter import (
    make_torch_bundle,
    to_torch_nchw,
    wrap_torch_transform,
)

__all__ = ["load_open_clip"]


def load_open_clip(model_name: str, pretrained: str = "", device: str = "cpu",
                   cache_dir=None, **kwargs):
    try:
        import open_clip
    except ImportError as e:
        raise ImportError(
            "Install `open_clip_torch` to use --model_type open_clip/nllb_clip"
        ) from e
    import torch

    model, _, transform = open_clip.create_model_and_transforms(
        model_name, pretrained=pretrained or None, cache_dir=cache_dir,
        device=device,
    )
    model.eval()
    tokenizer = open_clip.get_tokenizer(model_name)

    def encode_image(images) -> np.ndarray:
        with torch.no_grad():
            feats = model.encode_image(to_torch_nchw(images, device))
        return feats.cpu().numpy()

    def encode_texts(texts) -> np.ndarray:
        tokens = tokenizer(list(texts))
        if hasattr(tokens, "to"):
            tokens = tokens.to(device)
        with torch.no_grad():
            feats = model.encode_text(tokens)
        return feats.cpu().numpy()

    bundle = make_torch_bundle(encode_image, encode_texts, tokenizer, device)
    return bundle, wrap_torch_transform(transform), tokenizer
