"""torchvision ResNet and DenseNet state dicts, and the standard SimpleViT
of the B-cos hub, -> the port's state dict (counterpart of
``bcosification_tpu/bcosify/torch_import.py::{resnet,densenet,simple_vit}_
torch_to_variables``).

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

__all__ = ["resnet_state_dict", "densenet_state_dict", "simple_vit_state_dict",
           "fill_state_dict"]

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


class _Import:
    """The strict conversion of one torchvision state dict ``tsd``: ``take``
    marks an entry as used, ``bn`` converts a BatchNorm, ``finish`` checks
    that every entry but ``droppable`` was used and fills the model's
    state dict."""

    def __init__(self, tsd: Mapping[str, Any], *, fold_bn_bias: bool, use_bias: bool):
        self.tsd, self.fold_bn_bias, self.use_bias = tsd, fold_bn_bias, use_bias
        self.used = set()
        self.flat: Dict[str, np.ndarray] = {}

    def take(self, key: str) -> np.ndarray:
        if key not in self.tsd:
            raise KeyError(f"missing torchvision entry {key}")
        self.used.add(key)
        return _np(self.tsd[key])

    def bn(self, src: str, dst: str) -> None:
        w, b = self.take(f"{src}.weight"), self.take(f"{src}.bias")
        mean, var = self.take(f"{src}.running_mean"), self.take(f"{src}.running_var")
        self.flat[f"{dst}.weight"] = w
        if self.use_bias:
            self.flat[f"{dst}.bias"] = (P.bn_uncentered_fold_bias(b, mean, var, w, _BN_EPS)
                                        if self.fold_bn_bias else b)
        self.flat[f"{dst}.running_var"] = var
        tracked = f"{src}.num_batches_tracked"
        self.flat[f"{dst}.num_batches_tracked"] = (self.take(tracked) if tracked in self.tsd
                                                   else np.zeros((), np.int32))

    def linear(self, src: str, dst: str, bias: bool = True) -> None:
        """An (out, in) Linear as the port's (in, out) weight [and bias]."""
        self.flat[f"{dst}.weight"] = np.ascontiguousarray(self.take(f"{src}.weight").T)
        if bias:
            self.flat[f"{dst}.bias"] = self.take(f"{src}.bias")

    def copy(self, src: str, dst: str) -> None:
        self.flat[dst] = self.take(src)

    def classifier(self, src: str, dst: str) -> None:
        """The Linear ``src`` as the 1x1 conv ``dst`` of the GAP-reorder
        head; its bias only with ``use_bias``."""
        self.flat[f"{dst}.weight"] = P.linear_to_conv1x1_weight(self.take(f"{src}.weight"))
        if self.use_bias and f"{src}.bias" in self.tsd:
            self.flat[f"{dst}.bias"] = self.take(f"{src}.bias")

    def finish(self, net: torch.nn.Module, droppable=()) -> Dict[str, torch.Tensor]:
        unused = sorted(set(self.tsd) - self.used - set(droppable))
        if unused:
            raise KeyError(f"torchvision entries that map onto nothing: {unused[:10]}")
        return fill_state_dict(net, self.flat)


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
    imp = _Import(tsd, fold_bn_bias=fold_bn_bias, use_bias=use_bias)
    imp.flat["model.conv1.weight"] = P.add_channels_conv_weight(imp.take("conv1.weight"))
    imp.bn("bn1", "model.bn1")

    m = net.model
    n_convs = 3 if m.block == "bottleneck" else 2
    for stage, j, _, _, has_ds in m.block_cfgs():
        src, dst = f"layer{stage + 1}.{j}", f"model.layer{stage + 1}_{j}"
        for k in range(1, n_convs + 1):
            imp.flat[f"{dst}.conv{k}.weight"] = imp.take(f"{src}.conv{k}.weight")
            imp.bn(f"{src}.bn{k}", f"{dst}.bn{k}")
        if has_ds:
            imp.flat[f"{dst}.downsample_conv.weight"] = imp.take(f"{src}.downsample.0.weight")
            imp.bn(f"{src}.downsample.1", f"{dst}.downsample_norm")

    imp.classifier("fc", "model.fc")
    return imp.finish(net, droppable=("fc.bias",))


def densenet_state_dict(
    tsd: Mapping[str, Any],
    net: torch.nn.Module,
    *,
    fold_bn_bias: bool = True,
    use_bias: bool = False,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``net`` (a BcosifyNetwork(BcosDenseNet), 6-channel
    AddInverse input) converted from the torchvision DenseNet state dict
    ``tsd`` (features.conv0, features.norm0,
    features.denseblockI.denselayerJ.{norm1,conv1,norm2,conv2},
    features.transitionI.{norm,conv}, features.norm5, classifier), with the
    transforms of ``resnet_state_dict``: conv0's channel doubling, the
    BnUncV2 bias fold, biases only with ``use_bias``, the classifier's
    Linear as a 1x1 conv."""
    imp = _Import(tsd, fold_bn_bias=fold_bn_bias, use_bias=use_bias)
    m = net.model
    imp.flat["model.conv0.weight"] = P.add_channels_conv_weight(
        imp.take("features.conv0.weight"))
    imp.bn("features.norm0", "model.norm0")
    for i, num_layers in enumerate(m.block_config):
        for j in range(num_layers):
            src = f"features.denseblock{i + 1}.denselayer{j + 1}"
            dst = f"model.denseblock{i + 1}_denselayer{j + 1}"
            for k in (1, 2):
                imp.bn(f"{src}.norm{k}", f"{dst}.norm{k}")
                imp.flat[f"{dst}.conv{k}.weight"] = imp.take(f"{src}.conv{k}.weight")
        if m.transition(i) is not None:
            src, dst = f"features.transition{i + 1}", f"model.transition{i + 1}"
            imp.bn(f"{src}.norm", f"{dst}.norm")
            imp.flat[f"{dst}.conv.weight"] = imp.take(f"{src}.conv.weight")
    imp.bn("features.norm5", "model.norm5")
    imp.classifier("classifier", "model.classifier")
    return imp.finish(net, droppable=("classifier.bias",))


def simple_vit_state_dict(
    tsd: Mapping[str, Any],
    net: torch.nn.Module,
    *,
    use_bias: bool = False,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``net`` (a BcosifyNetwork(SimpleViT), 6-channel
    AddInverse input) converted from the hub's *standard* SimpleViT state
    dict ``tsd`` (to_patch_embedding.linear, transformer.encoder_{i}.attn.
    {norm,to_qkv,to_out}, transformer.encoder_{i}.ff.net.{norm,linear1,
    linear2}, linear_head.{norm,linear}).

    The patch embedding's input columns are doubled per pixel
    (``params.vit_patchify_linear_add_channels``). to_qkv and to_out take
    their weights alone (both are bias-free); the norms' and the other
    linears' biases are kept only with ``use_bias``, and dropped otherwise.
    """
    imp = _Import(tsd, fold_bn_bias=False, use_bias=use_bias)
    m = net.model
    w = P.vit_patchify_linear_add_channels(imp.take("to_patch_embedding.linear.weight"))
    imp.flat["model.to_patch_embedding_linear.weight"] = np.ascontiguousarray(w.T)
    if use_bias:
        imp.copy("to_patch_embedding.linear.bias", "model.to_patch_embedding_linear.bias")
    dropped = ["to_patch_embedding.linear.bias"]

    def norm(src, dst):
        imp.copy(f"{src}.weight", f"{dst}.weight")
        if use_bias:
            imp.copy(f"{src}.bias", f"{dst}.bias")
        dropped.append(f"{src}.bias")

    def linear(src, dst):
        imp.linear(src, dst, bias=use_bias)
        dropped.append(f"{src}.bias")

    for i in range(m.depth):
        src, dst = f"transformer.encoder_{i}", f"model.encoder_{i}"
        norm(f"{src}.attn.norm", f"{dst}.attn.norm")
        imp.linear(f"{src}.attn.to_qkv", f"{dst}.attn.to_qkv", bias=False)
        imp.linear(f"{src}.attn.to_out", f"{dst}.attn.to_out", bias=False)
        norm(f"{src}.ff.net.norm", f"{dst}.ff.norm")
        linear(f"{src}.ff.net.linear1", f"{dst}.ff.linear1")
        linear(f"{src}.ff.net.linear2", f"{dst}.ff.linear2")
    norm("linear_head.norm", "model.linear_head_norm")
    linear("linear_head.linear", "model.linear_head_linear")
    return imp.finish(net, droppable=() if use_bias else dropped)
