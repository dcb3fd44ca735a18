"""Model factory of ImageNet/vit_bcosification (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/vit_bcosification/model.py``): the
hub's standard SimpleViT, B-cosified by ``bcosify/engine.py::
build_bcosified_vit`` (the patch embedding channel-doubled, every linear
but to_qkv a BcosifyLinear, the detachable LayerNorm and GELU, biases
nulled unless use_bias), in the 6-channel BcosifyNetwork wrapper with the
LogitLayer.

The standard checkpoint is read from ``$BCOS_HUB_PATH/standard_<arch>.
{pth,pt,npz}``; nothing is downloaded. Without it the net is initialised at
random, with the JAX package's warning. The ViT-C archs (``vitc_*``) are
not in ``VIT_CONFIGS`` and raise a KeyError, as in the JAX package.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch

from bcosification_tpu_torch.bcosify.engine import build_bcosified_vit

__all__ = ["get_model", "load_hub_state_dict"]


def load_hub_state_dict(arch_name: str):
    """The hub's standard_<arch_name> state dict from $BCOS_HUB_PATH (``.pth``
    or ``.pt`` torch pickles, or ``.npz``), or None (random init, with a
    warning) when the variable is unset or no file is there."""
    root = os.getenv("BCOS_HUB_PATH")
    if not root:
        warnings.warn(
            f"BCOS_HUB_PATH not set; standard_{arch_name} will be randomly "
            "initialised instead of hub-pretrained."
        )
        return None
    for ext in (".pth", ".pt", ".npz"):
        path = Path(root) / f"standard_{arch_name}{ext}"
        if path.exists():
            if ext == ".npz":
                return dict(np.load(path))
            sd = torch.load(path, map_location="cpu", weights_only=True)
            return sd.get("model", sd) if isinstance(sd, dict) else sd
    warnings.warn(f"No hub checkpoint for standard_{arch_name} under {root}.")
    return None


def get_model(model_config, device=None):
    """The B-cosified SimpleViT of ``model_config`` in eval mode on
    ``device`` (default the GPU; ``"cpu"`` when asked)."""
    state_dict = (load_hub_state_dict(model_config["name"])
                  if model_config.get("weights") else None)
    num_classes = model_config.get("args", {}).get("num_classes", 1000)
    return build_bcosified_vit(model_config, state_dict, num_classes=num_classes,
                               device=device)
