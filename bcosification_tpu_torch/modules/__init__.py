"""Modules of the port: B-cos layers, norms and activations."""
from bcosification_tpu_torch.modules.activations import DetachableGELU, Identity, PlainReLU, ReLU
from bcosification_tpu_torch.modules.bcos_layers import (
    BcosConv2d,
    BcosifyConv2d,
    BcosifyLinear,
    BcosLinear,
    LogitLayer,
    PlainConv2d,
    PlainLinear,
)
from bcosification_tpu_torch.modules.norms import (
    BatchNormUncentered2d,
    DetachableGNLayerNorm2d,
    DetachableLayerNorm,
    DetachablePositionNorm2d,
    NoBias,
)

__all__ = [
    "BatchNormUncentered2d",
    "BcosConv2d",
    "BcosifyConv2d",
    "BcosifyLinear",
    "BcosLinear",
    "DetachableGELU",
    "DetachableGNLayerNorm2d",
    "DetachableLayerNorm",
    "DetachablePositionNorm2d",
    "Identity",
    "LogitLayer",
    "NoBias",
    "PlainConv2d",
    "PlainLinear",
    "ReLU",
    "PlainReLU",
]
