"""Model factory of ImageNet/clip_bcosification (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/clip_bcosification/model.py``): the
OpenAI CLIP-RN50 image tower, B-cosified by ``bcosify/clip_import.py``
(biases and the attention pool's positional embedding nulled, c_proj
B-cosified), in the 6-channel BcosifyNetwork wrapper without a logit layer.

The OpenAI checkpoint is read from local files (``clip/load.py``:
$CLIP_WEIGHTS_PATH, $CLIP_WEIGHTS_DIR/RN50.pt); nothing is downloaded.
Without it the tower is initialised at random, with the JAX package's
warning. The CLIP ViT towers raise, naming the slice that brings them.
"""
from __future__ import annotations

from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual
from bcosification_tpu_torch.clip.load import MODEL_CONFIG_CLIP_NAMES, load_state_dict_file
from bcosification_tpu_torch.clip.model import VIT_SLICE

__all__ = ["get_model"]


def get_model(model_config, device=None):
    """The B-cosified CLIP tower of ``model_config`` in eval mode on
    ``device`` (default the GPU; ``"cpu"`` when asked)."""
    assert model_config.get("is_bcos", False), "Should be true!"
    name = model_config.get("name", "resnet50clip")
    if name not in MODEL_CONFIG_CLIP_NAMES:
        raise ValueError(f"unsupported CLIP model {name!r}")
    if name.startswith("vit"):
        raise NotImplementedError(f"CLIP tower {name!r}: it comes with {VIT_SLICE}")
    sd = load_state_dict_file(MODEL_CONFIG_CLIP_NAMES[name])
    return build_bcosified_clip_visual(model_config, sd, device=device)
