"""Modules of the port: B-cos layers, norms and activations."""
from bcosification_tpu_torch.modules.activations import Identity, ReLU
from bcosification_tpu_torch.modules.bcos_layers import (
    BcosConv2d,
    BcosifyConv2d,
    BcosifyLinear,
    LogitLayer,
    PlainLinear,
)
from bcosification_tpu_torch.modules.norms import BatchNormUncentered2d, NoBias

__all__ = [
    "BatchNormUncentered2d",
    "BcosConv2d",
    "BcosifyConv2d",
    "BcosifyLinear",
    "Identity",
    "LogitLayer",
    "NoBias",
    "PlainLinear",
    "ReLU",
]
