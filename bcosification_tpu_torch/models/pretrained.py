"""Pretrained-model entry points, local weights only (counterpart of
``bcosification_tpu/models/pretrained.py``).

``load_model(name)`` builds a registered model and fills it from
``$BCOS_WEIGHTS_DIR/<name>.npz``, or from the newest sha-stamped
``<name>-<sha8..64>.npz`` there: the npz files that the JAX package's
``scripts/import_torch_checkpoint.py`` and ``scripts/strip_checkpoints.py``
write (keys 'params/a/b/c' and 'batch_stats/a/b/c', conv kernels HWIO). They
load through ``bcosify/from_jax.py``. When nothing resolves, the model keeps
its random init and a warning says so.

The registry holds the bcosified ResNets the port builds, under the
bcosification experiments' names. The JAX package's other entry points
(the from-scratch B-cos ResNets, DenseNets, VGGs, ConvNeXts, ViTs) raise
"not ported yet". The port has no network path: the JAX package's download
(``BCOS_ALLOW_DOWNLOAD=1``) raises here.
"""
from __future__ import annotations

import os
import re
import warnings
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

__all__ = ["list_available", "load_model", "resolve_weights", "fetch_checkpoint"]

_VITS = (
    "simple_vit_ti_patch16_224", "simple_vit_s_patch16_224", "simple_vit_b_patch16_224",
    "simple_vit_l_patch16_224", "vitc_ti_patch1_14", "vitc_s_patch1_14", "vitc_b_patch1_14",
    "vitc_l_patch1_14",
)
# entry points of the JAX package's registry that the port cannot build yet
NOT_PORTED = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "wide_resnet50_2", "resnet50_long", "resnet152_long",
    "densenet121", "densenet161", "densenet169", "densenet201", "densenet121_long",
    "vgg11", "vgg11_bnu", "vgg13", "vgg13_bnu", "vgg16", "vgg16_bnu", "vgg19", "vgg19_bnu",
    "convnext_atto", "convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
    "convnext_tiny_bnu", "convnext_base_bnu",
    *_VITS, *(f"standard_{name}" for name in _VITS),
)

# the bcosification experiments' ResNet recipe (experiments/ImageNet/
# bcosification/experiment_parameters.py of the JAX package)
BCOSIFIED_RESNET = {
    "bcosify_args": {"fix_b": True, "use_bias": False, "norm_layer": "BnUncV2",
                     "gap": True, "act_layer": True},
    "bcos_args": {"b": 2},
}
# entry point -> factory(**kwargs) of the randomly initialised model
_REGISTRY: Dict[str, Callable] = {
    name: partial(build_bcosified_resnet, {**BCOSIFIED_RESNET, "name": arch})
    for name, arch in (("resnet_18", "resnet18"), ("resnet_50", "resnet50"),
                       ("resnet_18_V1", "resnet18"), ("resnet_50_V1", "resnet50"))
}


def list_available() -> List[str]:
    return sorted(_REGISTRY)


def fetch_checkpoint(*args, **kwargs):
    """The JAX package downloads released checkpoints; the port has no
    network path."""
    raise RuntimeError("the PyTorch port has no network path: put the weights in "
                       "$BCOS_WEIGHTS_DIR as <name>.npz instead")


def resolve_weights(name: str) -> Optional[Path]:
    """$BCOS_WEIGHTS_DIR/<name>.npz, else the newest <name>-<sha8..64>.npz
    there (with a warning when there are several), else None."""
    root = os.getenv("BCOS_WEIGHTS_DIR")
    if not root:
        return None
    path = Path(root) / f"{name}.npz"
    if path.exists():
        return path
    stamped = [p for p in Path(root).glob(f"{name}-*.npz")
               if re.fullmatch(rf"{re.escape(name)}-[0-9a-f]{{8,64}}\.npz", p.name)]
    if not stamped:
        return None
    stamped.sort(key=lambda p: p.stat().st_mtime)
    if len(stamped) > 1:
        warnings.warn(f"multiple sha-stamped weights for {name!r}; using newest: "
                      f"{stamped[-1].name}")
    return stamped[-1]


def _variables_from_npz(path: Path) -> dict:
    """The npz's {'a/b/c': array} entries as a nested variables tree."""
    tree: dict = {}
    with np.load(path) as npz:  # plain arrays only: allow_pickle stays off
        for key in npz.files:
            *scopes, leaf = key.split("/")
            node = tree
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = npz[key]
    return tree


def load_model(name: str, pretrained: bool = True, **kwargs):
    """The registered model ``name`` built with ``kwargs`` (e.g. device=),
    its weights from $BCOS_WEIGHTS_DIR when ``pretrained``."""
    if name not in _REGISTRY:
        if name in NOT_PORTED:
            raise NotImplementedError(f"entry point {name!r} is not ported yet; "
                                      f"available: {list_available()}")
        raise ValueError(f"Unknown entrypoint {name!r}. Available: {list_available()}")
    net = _REGISTRY[name](**kwargs)
    if not pretrained:
        return net
    path = resolve_weights(name)
    if path is None:
        if os.getenv("BCOS_ALLOW_DOWNLOAD", "0") == "1":
            fetch_checkpoint(name)
        where = os.getenv("BCOS_WEIGHTS_DIR")
        warnings.warn(f"no weights for {name!r} in "
                      f"{where or 'BCOS_WEIGHTS_DIR (not set)'}: random init")
        return net
    load_jax_variables(net, _variables_from_npz(path))
    return net

