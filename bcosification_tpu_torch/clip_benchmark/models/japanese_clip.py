"""Japanese CLIP/CLOOB (rinna) loader.

Parity target: `CLIP_benchmark/clip_benchmark/models/
japanese_clip.py` — a thin wrapper over the external ``japanese_clip``
package (import-gated exactly like the reference): the model's
get_image_features/get_text_features become the bundle's encoders, and the
package tokenizer (which returns input_ids + attention_mask + position_ids
dicts) is closed over by the text encoder.
"""
from __future__ import annotations

import numpy as np

from bcosification_tpu_torch.clip_benchmark.models.torch_adapter import (
    make_torch_bundle,
    to_torch_nchw,
    wrap_torch_transform,
)

__all__ = ["load_japanese_clip"]


def load_japanese_clip(pretrained: str, device: str = "cpu", cache_dir=None, **kwargs):
    """-> (ModelBundle, transform, tokenizer). Requires the rinna package."""
    try:
        import japanese_clip as ja_clip
    except ImportError as e:
        raise ImportError(
            "Install `japanese_clip` by "
            "`pip install git+https://github.com/rinnakk/japanese-clip.git`"
        ) from e
    import torch

    model, transform = ja_clip.load(pretrained, device=device, cache_dir=cache_dir)
    tokenizer = ja_clip.load_tokenizer()

    def encode_image(images) -> np.ndarray:
        with torch.no_grad():
            feats = model.get_image_features(to_torch_nchw(images, device))
        return feats.cpu().numpy()

    def encode_texts(texts) -> np.ndarray:
        # NB: get_text_features needs input_ids AND attention_mask/position_ids
        inputs = ja_clip.tokenize(list(texts), tokenizer=tokenizer, device=device)
        with torch.no_grad():
            feats = model.get_text_features(**inputs)
        return feats.cpu().numpy()

    bundle = make_torch_bundle(encode_image, encode_texts, tokenizer, device)
    return bundle, wrap_torch_transform(transform), tokenizer
