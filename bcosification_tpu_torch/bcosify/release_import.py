"""Released B-cos v2 checkpoints -> the port's state dict (counterpart of
``bcosification_tpu/bcosify/release_import.py``), from local files only.

The reference releases plain ``state_dict()`` snapshots of its from-scratch
B-cos models; the ViTs are wrapped in ``BcosSequential(model, LogitLayer)``,
so their keys carry a ``0.`` prefix (the ``standard_*`` baselines do not).
``convert_release_checkpoint(name, source)`` fills the model that
``models.pretrained.load_model(name)`` builds, which it builds shape-only
(``utils/init_mode.py``), from such a checkpoint. The translation is strict
both ways: every tensor of the port's model must be found, every checkpoint
tensor must be used (except ``num_batches_tracked``, and a
``running_mean`` beside a used ``running_var``: the uncentered norms never
read it), and a shape the model does not have raises.

Layouts: B-cos convs and linears live under ``<module>.linear.weight`` in
the reference (the ViT patch embedding's under
``to_patch_embedding.linear.linear.weight``), plain ones under
``<module>.weight``. Conv weights are OIHW on both sides; linear weights
are (out, in) in the reference and (in, out) in the port; ConvNeXt's
``layer_scale`` is (C, 1, 1) in the reference and (C,) in the port. The
port's module names are the JAX package's scopes, so the scope translators
are the JAX package's. VGG's (the reference's Sequential counts every
module: pools, and an Identity in place of each norm of a norm-free VGG)
and ConvNeXt's (one Sequential slot per stage, one more per downsampling)
take what they need from the port's model: whether the VGG has norms, and
which ConvNeXt stages downsample.

A checkpoint with BatchNorm running statistics under an entry point whose
default norm has none (the released zoo trained both position-norm and
uncentered-BN flavours under one architecture name) rebuilds the ResNet,
DenseNet or ConvNeXt with the bias-free ``BatchNormUncentered2d`` (and the
other way round): that ResNet folds its norms into K1 at every 1x1 conv.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.modules import BcosConv2d, BcosLinear, norms
from bcosification_tpu_torch.utils.init_mode import abstract_init

__all__ = ["convert_release_checkpoint", "convert_state_dict", "family_of",
           "load_torch_state_dict", "release_state_dict"]


def _np(x) -> np.ndarray:
    arr = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def load_torch_state_dict(source: Union[str, Path, Mapping]) -> Dict[str, np.ndarray]:
    """A checkpoint as a flat {reference key: array}: a mapping, or a local
    ``torch.save`` file read with ``weights_only=True`` (a file that needs
    full unpickling raises). The ``{"state_dict": ...}`` / ``{"model": ...}``
    nesting is unwrapped and DataParallel's ``module.`` prefix stripped."""
    obj = (torch.load(source, map_location="cpu", weights_only=True)
           if isinstance(source, (str, Path)) else source)
    for nest in ("state_dict", "model"):
        if isinstance(obj, Mapping) and isinstance(obj.get(nest), Mapping):
            obj = obj[nest]
    return {(k[len("module."):] if k.startswith("module.") else k): _np(v)
            for k, v in obj.items()}


# --------------------------------------------------------------------------
# per-family translators: the port's (= JAX's) scopes -> the reference's path
# --------------------------------------------------------------------------
def _tpath_resnet(scope: Sequence[str]) -> str:
    out: List[str] = []
    for s in scope:
        if s.startswith("layer") and "_" in s:
            out += s.split("_")
        elif s == "downsample_conv":
            out += ["downsample", "0"]
        elif s == "downsample_norm":
            out += ["downsample", "1"]
        else:
            out.append(s)  # conv1 / bn1 / fc
    return ".".join(out)


def _tpath_densenet(scope: Sequence[str]) -> str:
    out: List[str] = []
    for s in scope:
        if s.startswith("denseblock"):
            i, j = s.split("_")
            out.append(f"features.{i}.{j}")
        elif s.startswith("transition") or s in ("conv0", "norm0", "norm5"):
            out.append(f"features.{s}")
        else:
            out.append(s)  # norm1/conv1/norm2/conv2/norm/conv/classifier
    return ".".join(out)


def _make_tpath_vgg(cfg: Sequence, with_norm: bool) -> Callable:
    """features_{i} counts convs and norms; the reference's Sequential counts
    every module: each pool, and after each conv its norm or, without
    norms, the Identity in its place."""
    ours_to_ref: Dict[str, str] = {}
    ref_idx = our_idx = 0
    for v in cfg:
        if v == "M":
            ref_idx += 1
            continue
        ours_to_ref[f"features_{our_idx}"] = f"features.{ref_idx}"
        if with_norm:
            ours_to_ref[f"features_{our_idx + 1}"] = f"features.{ref_idx + 1}"
        our_idx += 2 if with_norm else 1
        ref_idx += 2
    for i in range(3):
        ours_to_ref[f"classifier_{i}"] = f"classifier.{i}"

    def tpath(scope: Sequence[str]) -> str:
        return ".".join(ours_to_ref.get(s, s) for s in scope)

    return tpath


def _make_tpath_convnext(downsampled: Sequence[bool]) -> Callable:
    """The reference's features Sequential: the stem's conv and norm at 0
    and 1, then one slot per stage and one more for each stage's
    (norm, conv) downsampling."""

    def feature_idx(si: int) -> int:
        return 2 + sum(2 if d else 1 for d in downsampled[:si])

    def tpath(scope: Sequence[str]) -> str:
        out: List[str] = []
        for s in scope:
            if s in ("stem_conv", "stem_norm"):
                out.append("features.0" if s == "stem_conv" else "features.1")
            elif s.startswith("stage"):
                si, bi = s[len("stage"):].split("_block")
                out.append(f"features.{feature_idx(int(si))}.{bi}")
            elif s.startswith("down"):
                si, kind = s[len("down"):].split("_")
                out.append(f"features.{feature_idx(int(si)) + 1}."
                           + ("0" if kind == "norm" else "1"))
            elif s.startswith("block_"):
                out.append(f"block.{s[len('block_'):]}")
            elif s in ("classifier_norm", "classifier_conv"):
                out.append("classifier.0" if s == "classifier_norm" else "classifier.1")
            else:
                out.append(s)
        return ".".join(out)

    return tpath


def _make_tpath_vit(prefix: str) -> Callable:
    def tpath(scope: Sequence[str]) -> str:
        out: List[str] = []
        for s in scope:
            if s.startswith("conv_stem_"):
                out.append(f"to_patch_embedding.conv_stem.{s[len('conv_stem_'):]}")
            elif s == "to_patch_embedding_linear":
                out.append("to_patch_embedding.linear")
            elif s.startswith("encoder_"):
                out.append(f"transformer.{s}")
            elif s == "ff":
                out.append("ff.net")
            elif s == "linear_head_norm":
                out.append("linear_head.norm")
            elif s == "linear_head_linear":
                out.append("linear_head.linear")
            else:
                out.append(s)
        return prefix + ".".join(out)

    return tpath


def family_of(name: str) -> str:
    base = name[len("standard_"):] if name.startswith("standard_") else name
    if base.startswith(("resnet", "resnext", "wide_resnet")):
        return "resnet"
    if base.startswith("densenet"):
        return "densenet"
    if base.startswith("vgg"):
        return "vgg"
    if base.startswith("convnext"):
        return "convnext"
    if base.startswith(("simple_vit", "vitc")):
        return "vit"
    raise ValueError(f"no released-checkpoint family for entrypoint {name!r}")


def _tpath_for(name: str, model: torch.nn.Module) -> Callable:
    """The scope translator of ``name``'s family for the port's ``model``."""
    family = family_of(name)
    if family == "resnet":
        return _tpath_resnet
    if family == "densenet":
        return _tpath_densenet
    if family == "vgg":
        from bcosification_tpu_torch.models.vgg import CFGS

        return _make_tpath_vgg(CFGS[model.cfg], model.with_norm)
    if family == "convnext":
        return _make_tpath_convnext([c.out_channels is not None for c in model.block_setting])
    # vit: the released B-cos ViTs carry BcosSequential's "0."
    return _make_tpath_vit("" if name.startswith("standard_") else "0.")


def _entries(model: torch.nn.Module):
    """(state-dict key, its scope, leaf name, owning module) of each entry."""
    owners = dict(model.named_modules())
    for key in model.state_dict():
        *scope, leaf = key.split(".")
        yield key, scope, leaf, owners[".".join(scope)]


def convert_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray],
                       tpath: Callable) -> Dict[str, torch.Tensor]:
    """{key: tensor} for every entry of ``model``'s state dict (shapes and
    dtypes its own, on the CPU), taken from the reference checkpoint ``sd``
    through the scope translator ``tpath``. Strict both ways."""
    used = set()

    def take(candidates: Sequence[str]) -> np.ndarray:
        for key in candidates:
            if key in sd:
                used.add(key)
                return np.asarray(sd[key])
        raise KeyError(f"none of {list(candidates)} found in the checkpoint")

    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, scope, leaf, _ in _entries(model):
        target = state[key]
        tp = tpath(scope)
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros(target.shape, dtype=target.dtype)
            continue
        if leaf == "weight" and target.dim() == 4:  # conv, OIHW on both sides
            arr = take([f"{tp}.linear.weight", f"{tp}.weight"])
        elif leaf == "weight" and target.dim() == 2:  # linear (in, out) <- (out, in)
            arr = take([f"{tp}.linear.weight", f"{tp}.weight"]).T
        elif leaf == "layer_scale":  # (C,) <- (C, 1, 1)
            arr = take([f"{tp}.layer_scale"])
            arr = arr.reshape(target.shape) if arr.size == target.numel() else arr
        else:  # norm weights and biases, running_var, linear biases
            arr = take([f"{tp}.{leaf}"])
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {arr.shape}, "
                             f"model {tuple(target.shape)}")
        out[key] = torch.as_tensor(np.array(arr)).to(target.dtype)
    leftover = sorted(k for k in sd if k not in used and not k.endswith("num_batches_tracked")
                      and not (k.endswith("running_mean") and k[:-len("mean")] + "var" in used))
    if leftover:
        raise KeyError(f"{len(leftover)} checkpoint tensors were not consumed: "
                       f"{leftover[:10]}")
    return out


def release_state_dict(model: torch.nn.Module, name: str) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_state_dict``: ``model``'s weights (the
    registry entry ``name``'s architecture) under the reference's keys and
    layouts, B-cos convs and linears under ``.linear.weight``, ConvNeXt's
    layer scales as (C, 1, 1)."""
    tpath = _tpath_for(name, model)
    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, scope, leaf, owner in _entries(model):
        t = state[key].detach().cpu()
        base = tpath(scope)
        if leaf == "weight" and isinstance(owner, (BcosConv2d, BcosLinear)):
            base += ".linear"
        if leaf == "weight" and t.dim() == 2:
            t = t.t().contiguous()
        elif leaf == "layer_scale":
            t = t.reshape(-1, 1, 1)
        out[f"{base}.{leaf}"] = t
    return out


def convert_release_checkpoint(name: str, source: Union[str, Path, Mapping],
                               rebuild_norm: bool = True, return_model: bool = False,
                               device=None, **model_kwargs):
    """The port's state dict of registry entry ``name`` (built with
    ``model_kwargs``) from a released checkpoint (a local ``.pth`` or a
    mapping); with ``return_model`` (model, state dict), the model on
    ``device`` (default the GPU; "cpu" when asked) in eval mode with the
    weights loaded: the model the conversion targeted, which differs from
    the registry's default when the norm flavour was rebuilt.

    ``rebuild_norm``: a ResNet, DenseNet or ConvNeXt checkpoint with running
    statistics under a stat-less default norm (or the other way round)
    rebuilds the net with
    the bias-free BatchNormUncentered2d (or DetachablePositionNorm2d);
    False makes such a mismatch raise, as a tree for the default build."""
    from bcosification_tpu_torch.models.pretrained import load_model

    sd = load_torch_state_dict(source)
    family_of(name)  # an unknown family raises before any build
    with abstract_init():
        model = load_model(name, pretrained=False, **model_kwargs)
        sd_has_stats = any(k.endswith("running_var") for k in sd)
        model_has_stats = any(k.endswith("running_var") for k in model.state_dict())
        if (rebuild_norm and sd_has_stats != model_has_stats
                and family_of(name) in ("resnet", "densenet", "convnext")
                and "norm_layer" not in model_kwargs):
            norm = norms.NoBias(norms.BatchNormUncentered2d if sd_has_stats
                                else norms.DetachablePositionNorm2d)
            model = load_model(name, pretrained=False, norm_layer=norm, **model_kwargs)
    state = convert_state_dict(model, sd, _tpath_for(name, model))
    if not return_model:
        return state
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict(state)
    return model, state
