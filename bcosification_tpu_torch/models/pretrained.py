"""Pretrained-model entry points, local weights only (counterpart of
``bcosification_tpu/models/pretrained.py``).

The registry holds every entry point of the JAX package's: the
from-scratch B-cos ResNets (resnet18 ... resnet152, resnext50_32x4d,
wide_resnet50_2), DenseNets (densenet121 ... densenet201), VGGs (vgg11 ...
vgg19, each also ``_bnu`` with the uncentered BN) and ConvNeXts
(convnext_atto ... convnext_large with the position norm, and
``convnext_tiny_bnu``/``convnext_base_bnu`` with the bias-free uncentered
BN), the ``_long`` names (the same architectures, longer trainings), the 8
B-cos ViTs through the vit_final factory with the released configs'
layers, and their 8 ``standard_*`` baselines.
``load_model(name, pretrained=False, **kw)`` builds the model
in eval mode on ``device`` (default the GPU; "cpu" when asked), its random
init seeded by ``seed`` (default 0; the CNNs are initialised on the CPU, so
every device gets the same weights); under ``utils.init_mode.abstract_init``
it builds on the meta device, shapes only.

With ``pretrained`` the weights come from ``$BCOS_WEIGHTS_DIR/<name>.npz``,
or the newest sha-stamped ``<name>-<sha8..64>.npz`` there: the npz files of
the JAX package's export scripts (keys 'params/a/b/c' and
'batch_stats/a/b/c', conv kernels HWIO), which load through
``bcosify/from_jax.py``. When nothing resolves, the model keeps its random
init and a warning names the release URL (``pretrained_url``). A released
``.pth`` converts from a local file with
``bcosify/release_import.py::convert_release_checkpoint``. The port has no
network path: the JAX package's download (``BCOS_ALLOW_DOWNLOAD=1``)
raises here.
"""
from __future__ import annotations

import json
import math
import os
import re
import warnings
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
from bcosification_tpu_torch.models import convnext, densenet, resnet, vgg
from bcosification_tpu_torch.modules import norms
from bcosification_tpu_torch.utils.init_mode import build_device

__all__ = ["list_available", "load_model", "resolve_weights", "fetch_checkpoint",
           "pretrained_urls", "pretrained_url"]

RESNETS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "wide_resnet50_2")
DENSENETS = ("densenet121", "densenet161", "densenet169", "densenet201")
VGGS = ("vgg11", "vgg11_bnu", "vgg13", "vgg13_bnu", "vgg16", "vgg16_bnu", "vgg19", "vgg19_bnu")
CONVNEXTS = ("convnext_atto", "convnext_tiny", "convnext_small", "convnext_base",
             "convnext_large")
CONVNEXT_BNU = {"convnext_tiny_bnu": "convnext_tiny", "convnext_base_bnu": "convnext_base"}
VITS = ("simple_vit_ti_patch16_224", "simple_vit_s_patch16_224", "simple_vit_b_patch16_224",
        "simple_vit_l_patch16_224", "vitc_ti_patch1_14", "vitc_s_patch1_14", "vitc_b_patch1_14",
        "vitc_l_patch1_14")
LONG = {"resnet50_long": "resnet50", "resnet152_long": "resnet152",
        "densenet121_long": "densenet121"}


# --------------------------------------------------------------------------
# the released-weights table
# --------------------------------------------------------------------------
@lru_cache(maxsize=1)
def pretrained_urls() -> Dict[str, Dict[str, str]]:
    """{release group: {experiment name: url}}: the reference's released
    B-cos v2 checkpoints. The port never downloads them."""
    return json.loads((Path(__file__).parent / "assets" / "pretrained_urls.json").read_text())


# entry point -> (group, key) where the generic rule below misses the
# reference's mapping: the convnext_tiny/base entries serve the _pn weights,
# the _long ones the base name in bcos_final_long, and resnext's key keeps
# 'x4d' whole
_URL_ALIASES: Dict[str, Tuple[str, str]] = {
    "resnext50_32x4d": ("bcos_final", "resnext_50_32x4d"),
    "convnext_tiny": ("bcos_final_long", "convnext_tiny_pn"),
    "convnext_base": ("bcos_final_long", "convnext_base_pn"),
    "resnet50_long": ("bcos_final_long", "resnet_50"),
    "resnet152_long": ("bcos_final_long", "resnet_152"),
    "densenet121_long": ("bcos_final_long", "densenet_121"),
}


def pretrained_url(name: str) -> Optional[str]:
    """The release URL of an entry point ('resnet18') or experiment name
    ('resnet_18'), or None. The bare ViT names are B-cos models, whose
    release keys carry 'bcos_'; 'standard_*' names take the unprefixed keys."""
    groups = pretrained_urls()
    if name in _URL_ALIASES:
        group, key = _URL_ALIASES[name]
        return groups[group].get(key)
    if name.startswith("standard_"):
        candidates = [name[len("standard_"):]]
    else:
        candidates = [f"bcos_{name}", name]
    candidates += [re.sub(r"([a-z])(\d)", r"\1_\2", c) for c in list(candidates)]
    for group in groups.values():
        for c in candidates:
            if c in group:
                return group[c]
    return None


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
def _cnn(factory: Callable, **preset) -> Callable:
    """Entry point of a from-scratch CNN: built on the CPU from ``seed`` (or
    on meta under abstract_init), then moved to ``device``."""

    def build(*, device=None, seed: int = 0, **kwargs):
        dev = build_device(device)
        meta = dev.type == "meta"
        net = factory(**{**preset, **kwargs}, device=dev if meta else None,
                      generator=None if meta else torch.Generator().manual_seed(int(seed)))
        return net.to(dev).eval().requires_grad_(False)

    return build


def _vit(arch: str, is_bcos: bool) -> Callable:
    """Entry point of a ViT through the vit_final factory with the released
    configs' layers: for a B-cos one the bias-free detachable LayerNorm,
    Identity, 6 channels, the bias-free group LayerNorm in the ViT-C stem,
    b=2 and the logit bias log(1 / (num_classes - 1)); for a standard one
    the plain LayerNorm and GELU, 3 channels, no logit layer."""

    def build(*, device=None, seed: int = 0, **kwargs):
        from bcosification_tpu_torch.experiments.ImageNet.vit_final.model import get_model

        if is_bcos:
            args = dict(norm_layer=norms.NoBias(norms.DetachableLayerNorm),
                        act_layer="identity", channels=6,
                        norm2d_layer=norms.NoBias(norms.DetachableGNLayerNorm2d))
            nc = kwargs.get("num_classes", 1000)
            config = dict(is_bcos=True, name=arch, args=args, bcos_args=dict(b=2, max_out=1),
                          logit_bias=math.log(1.0 / (nc - 1)), seed=seed)
        else:
            args = dict(norm_layer=norms.PlainLayerNorm, channels=3,
                        norm2d_layer=norms.DetachableGNLayerNorm2d, act_layer="gelu_plain")
            config = dict(is_bcos=False, name=arch, args=args, seed=seed)
        return get_model(config, device=device, **kwargs)

    return build


_REGISTRY: Dict[str, Callable] = {
    **{name: _cnn(getattr(resnet, name)) for name in RESNETS},
    **{name: _cnn(getattr(densenet, name), with_logit_layer=True, stem_pool="avg")
       for name in DENSENETS},
    **{name: _cnn(getattr(vgg, name)) for name in VGGS},
    **{name: _cnn(getattr(convnext, name)) for name in CONVNEXTS},
    **{name: _cnn(getattr(convnext, base), norm_layer=norms.NoBias(norms.BatchNormUncentered2d))
       for name, base in CONVNEXT_BNU.items()},
    **{name: _vit(name, True) for name in VITS},
    **{f"standard_{name}": _vit(name, False) for name in VITS},
}
_REGISTRY.update({name: _REGISTRY[base] for name, base in LONG.items()})


def list_available() -> List[str]:
    return sorted(_REGISTRY)


def fetch_checkpoint(*args, **kwargs):
    """The JAX package downloads released checkpoints; the port has no
    network path."""
    raise RuntimeError("the PyTorch port has no network path: put the weights in "
                       "$BCOS_WEIGHTS_DIR as <name>.npz, or convert a local .pth with "
                       "bcosify.release_import.convert_release_checkpoint")


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
    """The registered model ``name`` built with ``kwargs`` (device=, seed=,
    and the architecture's own options), its weights from $BCOS_WEIGHTS_DIR
    when ``pretrained``."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown entrypoint {name!r}. Available: {list_available()}")
    net = _REGISTRY[name](**kwargs)
    if not pretrained:
        return net
    path = resolve_weights(name)
    if path is None:
        if os.getenv("BCOS_ALLOW_DOWNLOAD", "0") == "1":
            fetch_checkpoint(name)
        where = os.getenv("BCOS_WEIGHTS_DIR")
        url = pretrained_url(name)
        hint = (f" Released reference weights: {url}; convert a local copy with "
                "bcosify.release_import.convert_release_checkpoint." if url else "")
        warnings.warn(f"no weights for {name!r} in "
                      f"{where or 'BCOS_WEIGHTS_DIR (not set)'}: random init.{hint}")
        return net
    load_jax_variables(net, _variables_from_npz(path))
    return net
