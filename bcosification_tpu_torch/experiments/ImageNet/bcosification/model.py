"""Model factory of ImageNet/bcosification (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/bcosification/model.py``): the
bcosified torchvision ResNet of ``bcosify/engine.py::build_bcosified_resnet``
(GAP-reorder classifier, avg-pool stem, biases nulled, the 6-channel
BcosifyNetwork wrapper), with torchvision's weights converted by
``bcosify/torch_import.py``.

The weights are read from ``$TORCHVISION_WEIGHTS_DIR/<arch>.{pth,pt,npz}``;
nothing is downloaded. Without them the net is initialised at random, with
the JAX package's warning.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch

from bcosification_tpu_torch.bcosify.engine import RESNET_LAYERS, build_bcosified_resnet

__all__ = ["get_model", "load_torchvision_state_dict"]

DENSENET_SLICE = "port slice 4 (ROADMAP A6, the other families)"
# the only standard change the ResNet recipe makes, which the port's ResNet
# builds in (its stem pool is avg-pool 3x3/s2/p1)
SUPPORTED_CHANGES = {"maxpool": "avgpool_3_2_1"}


def load_torchvision_state_dict(arch_name: str, weights_spec):
    """The torchvision checkpoint of ``arch_name`` from
    $TORCHVISION_WEIGHTS_DIR (``.pth`` or ``.pt`` torch pickles, or ``.npz``),
    or None (random init, with a warning) when ``weights_spec`` is None, the
    variable is unset or no file is there."""
    if not weights_spec:
        return None
    root = os.getenv("TORCHVISION_WEIGHTS_DIR")
    if not root:
        warnings.warn(
            f"TORCHVISION_WEIGHTS_DIR not set; '{arch_name}' will be randomly "
            "initialised instead of using pretrained weights."
        )
        return None
    for ext in (".pth", ".pt", ".npz"):
        path = Path(root) / f"{arch_name}{ext}"
        if path.exists():
            if ext == ".npz":
                return dict(np.load(path))
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            return sd
    warnings.warn(f"No checkpoint for '{arch_name}' under {root}; random init.")
    return None


def get_model(model_config, device=None):
    """The bcosified net of ``model_config`` in eval mode on ``device``
    (default the GPU; ``"cpu"`` when asked)."""
    assert model_config.get("is_bcos", False), "Should be true!"
    arch_name = model_config["name"]
    if arch_name.startswith("densenet"):
        raise NotImplementedError(
            f"{arch_name}: the bcosified DenseNet is not ported yet; it comes in "
            f"{DENSENET_SLICE}")
    if arch_name not in RESNET_LAYERS:
        raise ValueError(f"unsupported arch {arch_name!r}")
    changes = model_config.get("standard_changes") or {}
    if any(SUPPORTED_CHANGES.get(k) != v for k, v in changes.items()):
        raise NotImplementedError(
            f"standard_changes {changes}: the port's ResNet supports only "
            f"{SUPPORTED_CHANGES}")
    state_dict = load_torchvision_state_dict(arch_name, model_config.get("weights"))
    num_classes = model_config.get("args", {}).get("num_classes", 1000)
    return build_bcosified_resnet(model_config, state_dict, num_classes=num_classes,
                                  device=device)
