"""Adapters wrapping external torch CLIP models (rinna japanese-clip,
open_clip incl. NLLB-CLIP) into the benchmark's ModelBundle interface.

The rest of the pipeline feeds NHWC images; these helpers convert at the
boundary: the external package's PIL transform is wrapped to emit numpy HWC
float32, and the encoders take an NHWC batch (numpy or a tensor) and return
numpy features.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["wrap_torch_transform", "to_torch_nchw", "make_torch_bundle"]


def wrap_torch_transform(transform) -> Callable:
    """PIL -> numpy HWC float32, via the external package's own transform
    (which emits torch CHW tensors)."""

    def apply(img):
        out = transform(img)
        arr = out.detach().cpu().numpy() if hasattr(out, "detach") else np.asarray(out)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = arr.transpose(1, 2, 0)  # CHW -> HWC
        return np.asarray(arr, np.float32)

    return apply


def to_torch_nchw(images, device):
    import torch

    t = torch.as_tensor(images, dtype=torch.float32)
    if t.ndim == 4 and t.shape[-1] in (1, 3, 6):  # NHWC -> NCHW
        t = t.permute(0, 3, 1, 2).contiguous()
    return t.to(device)


def make_torch_bundle(encode_image_np, encode_texts_np, tokenizer, device="cpu"):
    """ModelBundle over torch encoders that return numpy features."""
    import torch

    from bcosification_tpu_torch.clip_benchmark.models import ModelBundle

    return ModelBundle(
        encode_image=encode_image_np,
        text_model=None,
        tokenizer=tokenizer,
        device=torch.device(device),
        encode_texts_fn=encode_texts_np,
    )
