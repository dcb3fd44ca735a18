"""torchvision ResNet state dict -> the port's state dict (counterpart of
``bcosification_tpu/bcosify/torch_import.py::resnet_torch_to_variables``).

The conversion applies the B-cosification transforms (``bcosify/params.py``)
in the reference's order: the stem's channel doubling (``add_channels``)
first, then the BnUncV2 bias fold of every BatchNorm when ``use_bias`` keeps
the biases. OIHW conv weights stay OIHW; the classifier's Linear becomes the
1x1 conv of the GAP-reorder head. The import is strict: a torchvision entry
the model needs and does not find, a torchvision entry that maps onto
nothing, or a shape the model does not have raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bcosification_tpu_torch.bcosify import params as P

__all__ = ["resnet_state_dict", "fill_state_dict"]

# torchvision entries the bcosified model may drop by design: the fc bias
# when the recipe removes all biases
_DROPPABLE = ("fc.bias",)
# torchvision's BatchNorm eps, used by the BnUncV2 bias fold
_BN_EPS = 1e-5


def _np(w) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array; float64
    becomes float32, as in the JAX importer."""
    arr = np.asarray(w.detach().cpu() if hasattr(w, "detach") else w)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def fill_state_dict(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{name: tensor} in ``model``'s dtypes for every entry of its state
    dict. Raises on a missing, extra or mis-shaped entry."""
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    if missing:
        raise KeyError(f"missing parameters {missing[:10]}")
    extra = sorted(set(flat) - set(state))
    if extra:
        raise KeyError(f"unused imported parameters {extra}")
    out = {}
    for name, arr in flat.items():
        target = state[name]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {name}: got {tuple(arr.shape)}, "
                             f"expected {tuple(target.shape)}")
        out[name] = torch.as_tensor(np.array(arr)).to(target.dtype)
    return out


def resnet_state_dict(
    tsd: Mapping[str, Any],
    net: torch.nn.Module,
    *,
    fold_bn_bias: bool = True,
    use_bias: bool = False,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``net`` (a BcosifyNetwork(BcosResNet), 6-channel
    AddInverse input) converted from the torchvision ResNet state dict
    ``tsd``.

    ``use_bias`` keeps the (folded, when ``fold_bn_bias``) BN biases and the
    fc bias: the reference's recipe removes all biases, but keeping them
    makes the b=1 conversion exact.
    """
    used = set()

    def take(key: str) -> np.ndarray:
        if key not in tsd:
            raise KeyError(f"missing torchvision entry {key}")
        used.add(key)
        return _np(tsd[key])

    flat: Dict[str, np.ndarray] = {}

    def bn(src: str, dst: str) -> None:
        w, b = take(f"{src}.weight"), take(f"{src}.bias")
        mean, var = take(f"{src}.running_mean"), take(f"{src}.running_var")
        flat[f"{dst}.weight"] = w
        if use_bias:
            flat[f"{dst}.bias"] = (P.bn_uncentered_fold_bias(b, mean, var, w, _BN_EPS)
                                   if fold_bn_bias else b)
        flat[f"{dst}.running_var"] = var
        tracked = f"{src}.num_batches_tracked"
        flat[f"{dst}.num_batches_tracked"] = (take(tracked) if tracked in tsd
                                              else np.zeros((), np.int32))

    flat["model.conv1.weight"] = P.add_channels_conv_weight(take("conv1.weight"))
    bn("bn1", "model.bn1")

    m = net.model
    n_convs = 3 if m.block == "bottleneck" else 2
    for stage, j, _, _, has_ds in m.block_cfgs():
        src, dst = f"layer{stage + 1}.{j}", f"model.layer{stage + 1}_{j}"
        for k in range(1, n_convs + 1):
            flat[f"{dst}.conv{k}.weight"] = take(f"{src}.conv{k}.weight")
            bn(f"{src}.bn{k}", f"{dst}.bn{k}")
        if has_ds:
            flat[f"{dst}.downsample_conv.weight"] = take(f"{src}.downsample.0.weight")
            bn(f"{src}.downsample.1", f"{dst}.downsample_norm")

    flat["model.fc.weight"] = P.linear_to_conv1x1_weight(take("fc.weight"))
    if use_bias and "fc.bias" in tsd:
        flat["model.fc.bias"] = take("fc.bias")

    unused = sorted(set(tsd) - used - set(_DROPPABLE))
    if unused:
        raise KeyError(f"torchvision entries that map onto nothing: {unused[:10]}")
    return fill_state_dict(net, flat)
