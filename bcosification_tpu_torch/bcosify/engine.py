"""Build a bcosified ResNet (counterpart of
``bcosification_tpu/bcosify/engine.py::build_bcosified_resnet``).

The architecture: BcosifyConv2d convs (raw weights, fixed b), uncentered BN
(bias-free unless ``use_bias``), ReLU (or Identity), an avg-pool stem, the
classifier as a 1x1 conv before the global average pool, and the
BcosifyNetwork wrapper (6-channel Normalize + LogitLayer). The weights
come from a torchvision ResNet state dict (``bcosify/torch_import.py``) or
from a random init.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from bcosification_tpu_torch.bcosify.torch_import import resnet_state_dict
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.models import resnet as resnet_lib
from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork
from bcosification_tpu_torch.modules import (
    BatchNormUncentered2d,
    BcosifyConv2d,
    Identity,
    NoBias,
    ReLU,
)

__all__ = ["build_bcosified_resnet", "RESNET_LAYERS"]

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _bcosify_factories(model_config: Dict[str, Any]):
    bargs = model_config.get("bcosify_args", {}) or {}
    b = (model_config.get("bcos_args", {}) or {}).get("b", 2)
    for key in ("clamping", "learn_b", "clip_kd", "linearprobe_clip"):
        if bargs.get(key, False):
            raise NotImplementedError(f"bcosify_args.{key} is not ported yet")
    if model_config.get("bfy_mean_zero", False):
        raise NotImplementedError("bfy_mean_zero is not ported yet")
    use_bias = bargs.get("use_bias", False)
    norm_name = bargs.get("norm_layer", "BnUncV2")
    if norm_name not in ("BnUnc2d", "BnUncV2"):
        raise ValueError(f"unsupported norm_layer {norm_name!r}")
    conv_layer = partial(BcosifyConv2d, b=float(b))
    norm_layer = BatchNormUncentered2d if use_bias else NoBias(BatchNormUncentered2d)
    act_layer = ReLU if bargs.get("act_layer", True) else Identity
    return conv_layer, norm_layer, act_layer, use_bias, bargs


def build_bcosified_resnet(
    model_config: Dict[str, Any],
    state_dict=None,
    *,
    num_classes: int = 1000,
    inplanes: int = 64,
    layers: Optional[Tuple[str, Sequence[int]]] = None,
    device=None,
    seed: Optional[int] = None,
) -> BcosifyNetwork:
    """BcosifyNetwork(BcosResNet) in eval mode on ``device`` (default the
    GPU; raises without one unless device="cpu").

    With ``state_dict`` (a torchvision ResNet checkpoint) the weights are
    converted by ``resnet_state_dict``: the stem's channel doubling, the
    BnUncV2 bias fold when norm_layer is "BnUncV2", biases kept only with
    bcosify_args.use_bias. Without it the net is randomly initialised from
    ``seed`` (default: model_config's "seed", else 0).

    ``layers`` overrides RESNET_LAYERS[name] with a (block, counts) pair,
    e.g. ("bottleneck", (1, 1)) for a small test net.
    """
    dev = resolve_device(device)
    block, counts = layers if layers is not None else RESNET_LAYERS[model_config["name"]]
    conv_layer, norm_layer, act_layer, use_bias, bargs = _bcosify_factories(model_config)
    if seed is None:
        seed = model_config.get("seed", 0) or 0
    gen = torch.Generator().manual_seed(int(seed))
    backbone = resnet_lib.BcosResNet(
        block, counts, num_classes=num_classes, inplanes=inplanes,
        conv_layer=conv_layer, norm_layer=norm_layer, act_layer=act_layer,
        fc_layer=partial(conv_layer, use_bias=use_bias), stem_pool="avg",
        gap_reorder=bool(bargs.get("gap", True)), with_logit_layer=False, generator=gen,
    )
    net = BcosifyNetwork(backbone, num_classes=num_classes, with_logit_layer=True)
    if state_dict is not None:
        net.load_state_dict(resnet_state_dict(
            state_dict, net,
            fold_bn_bias=bargs.get("norm_layer", "BnUncV2") == "BnUncV2", use_bias=use_bias))
    return net.to(dev).eval().requires_grad_(False)
