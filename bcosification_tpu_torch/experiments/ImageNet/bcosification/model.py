"""Model factory of ImageNet/bcosification (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/bcosification/model.py``): the
bcosified torchvision ResNet or DenseNet of ``bcosify/engine.py``
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

from bcosification_tpu_torch.bcosify.engine import (
    RESNET_LAYERS,
    build_bcosified_densenet,
    build_bcosified_resnet,
)
from bcosification_tpu_torch.models.densenet import DENSENET_CONFIGS

__all__ = ["get_model", "load_torchvision_state_dict"]

# per family: its build function, its archs, and the one standard change
# its recipe makes, which the port's net builds in (the stem pool, in
# torchvision's naming, as avg-pool 3x3/s2/p1)
FAMILIES = (
    (build_bcosified_resnet, RESNET_LAYERS, {"maxpool": "avgpool_3_2_1"}),
    (build_bcosified_densenet, DENSENET_CONFIGS, {"features[3]": "avgpool_3_2_1"}),
)


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
    family = next((f for f in FAMILIES if arch_name in f[1]), None)
    if family is None:
        raise ValueError(f"unsupported arch {arch_name!r}")
    build, _, supported = family
    changes = model_config.get("standard_changes") or {}
    if any(supported.get(k) != v for k, v in changes.items()):
        raise NotImplementedError(
            f"standard_changes {changes}: the port's {arch_name} supports only {supported}")
    state_dict = load_torchvision_state_dict(arch_name, model_config.get("weights"))
    num_classes = model_config.get("args", {}).get("num_classes", 1000)
    return build(model_config, state_dict, num_classes=num_classes, device=device)
