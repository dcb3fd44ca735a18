"""Build a bcosified ResNet, DenseNet or SimpleViT (counterpart of
``bcosification_tpu/bcosify/engine.py::build_bcosified_{resnet,densenet}``
and of the ViT factory ``experiments/ImageNet/vit_bcosification/model.py``).

The architecture: BcosifyConv2d convs (raw weights; b fixed, or learnable
with bcosify_args.clamping or learn_b), uncentered BN (bias-free unless
``use_bias``), ReLU (or Identity), an avg-pool stem, the classifier as a 1x1
conv before the global average pool, and the BcosifyNetwork wrapper
(6-channel Normalize, with CLIP's constants under clip_kd or
linearprobe_clip, + LogitLayer). The ViT:
BcosifyLinear linears but ``to_qkv``, which stays plain, the detachable
LayerNorm and GELU. The weights come from a torchvision (or the hub's
standard SimpleViT) state dict (``bcosify/torch_import.py``) or from a
random init.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from bcosification_tpu_torch.bcosify.torch_import import (
    densenet_state_dict,
    resnet_state_dict,
    simple_vit_state_dict,
)
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.models import resnet as resnet_lib
from bcosification_tpu_torch.models.densenet import DENSENET_CONFIGS, BcosDenseNet
from bcosification_tpu_torch.models import vit as vit_lib
from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork, normalization_for
from bcosification_tpu_torch.modules import (
    BatchNormUncentered2d,
    BcosifyConv2d,
    BcosifyLinear,
    DetachableGELU,
    DetachableLayerNorm,
    Identity,
    NoBias,
    ReLU,
)

__all__ = ["build_bcosified_resnet", "build_bcosified_densenet", "build_bcosified_vit",
           "RESNET_LAYERS"]

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _bcosify_factories(model_config: Dict[str, Any]):
    """The layer factories of bcosify_args: BcosifyConv2d with the
    configured b (``clamping`` and ``learn_b``, the JAX ``b_loss``, make it
    learnable), the uncentered BN (bias-free unless ``use_bias``), ReLU or
    Identity."""
    bargs = model_config.get("bcosify_args", {}) or {}
    b = (model_config.get("bcos_args", {}) or {}).get("b", 2)
    use_bias = bargs.get("use_bias", False)
    norm_name = bargs.get("norm_layer", "BnUncV2")
    if norm_name not in ("BnUnc2d", "BnUncV2"):
        raise ValueError(f"unsupported norm_layer {norm_name!r}")
    conv_layer = partial(BcosifyConv2d, b=float(b), clamping=bargs.get("clamping", False),
                         b_loss=bargs.get("learn_b", False))
    norm_layer = BatchNormUncentered2d if use_bias else NoBias(BatchNormUncentered2d)
    act_layer = ReLU if bargs.get("act_layer", True) else Identity
    return conv_layer, norm_layer, act_layer, use_bias, bargs


def _normalization(model_config: Dict[str, Any]):
    """(mean, std) of the wrapper's Normalize: CLIP's under
    bcosify_args.clip_kd or linearprobe_clip (zero mean with the config's
    bfy_mean_zero), else ImageNet's."""
    bargs = model_config.get("bcosify_args", {}) or {}
    return normalization_for(clip_kd=bool(bargs.get("clip_kd", False)),
                             linearprobe_clip=bool(bargs.get("linearprobe_clip", False)),
                             bfy_mean_zero=bool(model_config.get("bfy_mean_zero", False)))


def _generator(model_config: Dict[str, Any], seed: Optional[int]) -> torch.Generator:
    """The random init's generator: ``seed``, else model_config's "seed", else 0."""
    if seed is None:
        seed = model_config.get("seed", 0) or 0
    return torch.Generator().manual_seed(int(seed))


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
    gen = _generator(model_config, seed)
    backbone = resnet_lib.BcosResNet(
        block, counts, num_classes=num_classes, inplanes=inplanes,
        conv_layer=conv_layer, norm_layer=norm_layer, act_layer=act_layer,
        fc_layer=partial(conv_layer, use_bias=use_bias), stem_pool="avg",
        gap_reorder=bool(bargs.get("gap", True)), with_logit_layer=False, generator=gen,
    )
    mean, std = _normalization(model_config)
    net = BcosifyNetwork(backbone, num_classes=num_classes, with_logit_layer=True, mean=mean,
                         std=std)
    if state_dict is not None:
        net.load_state_dict(resnet_state_dict(
            state_dict, net,
            fold_bn_bias=bargs.get("norm_layer", "BnUncV2") == "BnUncV2", use_bias=use_bias))
    return net.to(dev).eval().requires_grad_(False)


def build_bcosified_densenet(
    model_config: Dict[str, Any],
    state_dict: Optional[Mapping[str, Any]] = None,
    *,
    num_classes: int = 1000,
    arch_cfg: Optional[Dict[str, Any]] = None,
    device=None,
    seed: Optional[int] = None,
) -> BcosifyNetwork:
    """BcosifyNetwork(BcosDenseNet) in eval mode on ``device`` (default the
    GPU; raises without one unless device="cpu"): the layers of
    ``build_bcosified_resnet`` on DENSENET_CONFIGS[name], the avg-pool stem
    pool (the recipe's standard change features[3] -> AvgPool2d(3, 2, 1)).

    With ``state_dict`` (a torchvision DenseNet checkpoint) the weights are
    converted by ``densenet_state_dict``; without it the net is randomly
    initialised from ``seed`` (default: model_config's "seed", else 0).

    ``arch_cfg`` overrides DENSENET_CONFIGS[name] (growth_rate,
    block_config, num_init_features and optionally bn_size), e.g. for a
    small test net.
    """
    dev = resolve_device(device)
    cfg = arch_cfg if arch_cfg is not None else DENSENET_CONFIGS[model_config["name"]]
    conv_layer, norm_layer, act_layer, use_bias, bargs = _bcosify_factories(model_config)
    backbone = BcosDenseNet(
        num_classes=num_classes, conv_layer=conv_layer, norm_layer=norm_layer,
        act_layer=act_layer, fc_layer=partial(conv_layer, use_bias=use_bias), stem_pool="avg",
        gap_reorder=bool(bargs.get("gap", True)), generator=_generator(model_config, seed),
        **cfg,
    )
    mean, std = _normalization(model_config)
    net = BcosifyNetwork(backbone, num_classes=num_classes, with_logit_layer=True, mean=mean,
                         std=std)
    if state_dict is not None:
        net.load_state_dict(densenet_state_dict(
            state_dict, net,
            fold_bn_bias=bargs.get("norm_layer", "BnUncV2") == "BnUncV2", use_bias=use_bias))
    return net.to(dev).eval().requires_grad_(False)


def build_bcosified_vit(
    model_config: Dict[str, Any],
    state_dict: Optional[Mapping[str, Any]] = None,
    *,
    num_classes: int = 1000,
    arch_cfg: Optional[Dict[str, Any]] = None,
    device=None,
    seed: Optional[int] = None,
) -> BcosifyNetwork:
    """BcosifyNetwork(SimpleViT) of the vit_bcosification recipe in eval mode
    on ``device`` (default the GPU; raises without one unless device="cpu"):
    BcosifyLinear (b of bcos_args; a bias only with bcosify_args.use_bias)
    for every linear but to_qkv (plain, bias-free), the detachable LayerNorm
    (bias-free unless use_bias), the detachable GELU (Identity when
    model_config's "act_layer" is false), the head on the token mean or
    (``args.gap_reorder``) on each token, and the LogitLayer when
    model_config's "logit_layer" is true.

    With ``state_dict`` (the hub's standard SimpleViT) the weights are
    converted by ``simple_vit_state_dict``; without it the net is randomly
    initialised from ``seed`` (default: model_config's "seed", else 0).
    ``arch_cfg`` overrides VIT_CONFIGS[name] (dim, heads, mlp_dim, depth,
    patch_size, image_size), e.g. for a small test net.
    """
    dev = resolve_device(device)
    cfg = arch_cfg if arch_cfg is not None else vit_lib.VIT_CONFIGS[model_config["name"]]
    args = model_config.get("args", {}) or {}
    bargs = model_config.get("bcosify_args", {}) or {}
    use_bias = bool(bargs.get("use_bias", False))
    b = float((model_config.get("bcos_args", {}) or {}).get("b", 2))
    backbone = vit_lib.SimpleViT(
        num_classes=num_classes,
        linear_layer=partial(BcosifyLinear, b=b, use_bias=use_bias),
        norm_layer=DetachableLayerNorm if use_bias else NoBias(DetachableLayerNorm),
        act_layer=DetachableGELU if model_config.get("act_layer", True) else Identity,
        gap_reorder=bool(args.get("gap_reorder", False)),
        generator=_generator(model_config, seed), **cfg,
    )
    net = BcosifyNetwork(backbone, num_classes=num_classes,
                         with_logit_layer=bool(model_config.get("logit_layer", False)),
                         logit_bias=model_config.get("logit_bias"))
    if state_dict is not None:
        net.load_state_dict(simple_vit_state_dict(state_dict, net, use_bias=use_bias))
    return net.to(dev).eval().requires_grad_(False)
