"""OpenAI CLIP checkpoints into the port, and the B-cosified CLIP-RN50 builder
(counterpart of ``bcosification_tpu/bcosify/clip_import.py``, its ResNet
half).

- The text tower and the frozen teacher image tower take the checkpoint as
  it is (linear weights transposed to the port's (in, out) layout).
- The student (``BcosifyNetwork(ModifiedResNet)``) applies the reference's
  B-cosification: the stem conv doubled to the 6 AddInverse channels,
  every BN uncentered (its bias folded and kept only with
  ``bcosify_args.use_bias``), the attention pool's q/k/v kept plain and
  c_proj B-cosified (b=2), biases and the positional embedding nulled.

Each import is strict within the checkpoint's part that it reads (the keys
under ``visual.`` for an image tower, the others but ``logit_scale`` for the
text tower): a key the model needs and does not find, a key that maps onto
nothing (beside the entries the conversion drops) or a shape the model does
not have raises. The CLIP ViT towers come with the CLIP ViT slice
(``clip.model.VIT_SLICE``).
"""
from __future__ import annotations

import re
from functools import partial
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from bcosification_tpu_torch.bcosify import params as P
from bcosification_tpu_torch.bcosify.engine import _generator
from bcosification_tpu_torch.bcosify.torch_import import _Import, _np, fill_state_dict
from bcosification_tpu_torch.clip import model as clip_model
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork, normalization_for
from bcosification_tpu_torch.modules import (
    BatchNormUncentered2d,
    BcosifyConv2d,
    BcosifyLinear,
    NoBias,
    PlainLinear,
)

__all__ = [
    "clip_text_to_variables",
    "clip_visual_teacher_to_variables",
    "clip_visual_student_to_variables",
    "clip_trained_student_to_variables",
    "infer_clip_student_config",
    "build_clip_text",
    "build_clip_teacher_visual",
    "build_bcosified_clip_visual",
]

_PROJS = ("q_proj", "k_proj", "v_proj", "c_proj")


class _ClipImport(_Import):
    """``_Import`` over one part of a CLIP checkpoint."""

    def __init__(self, sd: Mapping[str, Any], visual: bool, **kwargs):
        part = {k: v for k, v in sd.items()
                if k.startswith("visual.") == visual and k != "logit_scale"}
        super().__init__(part, **kwargs)

    def teacher_bn(self, src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.copy(f"{src}.{leaf}", f"{dst}.{leaf}")


def clip_text_to_variables(text: torch.nn.Module, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of the port's ``TextTransformer`` ``text`` from an
    OpenAI checkpoint: the embeddings, the resblocks, ln_final and the
    text projection."""
    imp = _ClipImport(sd, visual=False, fold_bn_bias=False, use_bias=True)
    for name in ("positional_embedding", "text_projection"):
        imp.copy(name, name)
    imp.copy("token_embedding.weight", "token_embedding")
    for i in range(text.num_layers):
        src, dst = f"transformer.resblocks.{i}", f"resblocks_{i}"
        imp.flat[f"{dst}.attn_in_proj.weight"] = np.ascontiguousarray(
            imp.take(f"{src}.attn.in_proj_weight").T)
        imp.copy(f"{src}.attn.in_proj_bias", f"{dst}.attn_in_proj.bias")
        for s, d in (("attn.out_proj", "attn_out_proj"), ("mlp.c_fc", "mlp_c_fc"),
                     ("mlp.c_proj", "mlp_c_proj")):
            imp.linear(f"{src}.{s}", f"{dst}.{d}")
        for ln in ("ln_1", "ln_2"):
            imp.copy(f"{src}.{ln}.weight", f"{dst}.{ln}.weight")
            imp.copy(f"{src}.{ln}.bias", f"{dst}.{ln}.bias")
    imp.copy("ln_final.weight", "ln_final.weight")
    imp.copy("ln_final.bias", "ln_final.bias")
    return imp.finish(text)


def _trunk(imp: _ClipImport, tower, scope: str, bcosified: bool) -> list:
    """The ModifiedResNet trunk's entries; returns the keys the conversion
    may leave unread (the BNs' num_batches_tracked)."""
    bn = imp.bn if bcosified else imp.teacher_bn
    tracked = []
    for k in (1, 2, 3):
        w = imp.take(f"visual.conv{k}.weight")
        imp.flat[f"{scope}conv{k}.weight"] = (P.add_channels_conv_weight(w)
                                              if bcosified and k == 1 else w)
        bn(f"visual.bn{k}", f"{scope}bn{k}")
        tracked.append(f"visual.bn{k}")
    for stage, j, _, _, has_ds in tower.block_cfgs():
        src, dst = f"visual.layer{stage + 1}.{j}", f"{scope}layer{stage + 1}_{j}"
        for k in (1, 2, 3):
            imp.copy(f"{src}.conv{k}.weight", f"{dst}.conv{k}.weight")
            bn(f"{src}.bn{k}", f"{dst}.bn{k}")
            tracked.append(f"{src}.bn{k}")
        if has_ds:
            imp.copy(f"{src}.downsample.0.weight", f"{dst}.downsample_conv.weight")
            bn(f"{src}.downsample.1", f"{dst}.downsample_norm")
            tracked.append(f"{src}.downsample.1")
    return [f"{t}.num_batches_tracked" for t in tracked]


def clip_visual_teacher_to_variables(visual, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of the frozen teacher ``visual`` (a ModifiedResNet with
    the standard attention pool) from an OpenAI checkpoint, as it is."""
    imp = _ClipImport(sd, visual=True, fold_bn_bias=False, use_bias=True)
    droppable = _trunk(imp, visual, "", bcosified=False)
    imp.copy("visual.attnpool.positional_embedding", "attnpool.positional_embedding")
    for p in _PROJS:
        imp.linear(f"visual.attnpool.{p}", f"attnpool.{p}")
    return imp.finish(visual, droppable=droppable)


def clip_visual_student_to_variables(net, sd: Mapping[str, Any], *, attn_unpool: bool = False,
                                     use_bias: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of the student ``net`` (BcosifyNetwork(ModifiedResNet))
    from an OpenAI checkpoint, B-cosified: stem conv doubled, BNs
    uncentered with the BnUncV2 bias fold (biases kept only with
    ``use_bias``), the positional embedding dropped, q/k/v plain and c_proj
    B-cosified (only v and c with ``attn_unpool``)."""
    imp = _ClipImport(sd, visual=True, fold_bn_bias=True, use_bias=use_bias)
    droppable = _trunk(imp, net.model, "model.", bcosified=True)
    droppable.append("visual.attnpool.positional_embedding")
    projs = ("v_proj", "c_proj") if attn_unpool else _PROJS
    for p in projs:
        imp.linear(f"visual.attnpool.{p}", f"model.attnpool.{p}", bias=use_bias)
    droppable += [f"visual.attnpool.{p}.{leaf}" for p in _PROJS for leaf in ("weight", "bias")
                  if p not in projs or (leaf == "bias" and not use_bias)]
    return imp.finish(net, droppable=droppable)


def infer_clip_student_config(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The vision config (vision_layers, vision_width, embed_dim,
    image_resolution) and the ``attn_unpool`` / ``use_bias`` flags of a
    TRAINED B-cos CLIP student checkpoint, in the reference's layout
    (``model.conv1.linear.weight``, ``model.layer{s}.{j}...``,
    ``model.attnpool.{q,k,v,c}_proj...``)."""
    width = _np(sd["model.conv1.linear.weight"]).shape[0] * 2  # the stem's conv1: width // 2
    layers = [0, 0, 0, 0]
    for k in sd:
        m = re.match(r"model\.layer(\d)\.(\d+)\.conv1\.(linear\.)?weight$", k)
        if m:
            s, j = int(m.group(1)), int(m.group(2))
            layers[s - 1] = max(layers[s - 1], j + 1)
    c_proj = next(k for k in ("model.attnpool.c_proj.linear.weight",
                              "model.attnpool.c_proj.weight") if k in sd)
    return {
        "vision_layers": tuple(layers),
        "vision_width": width,
        "embed_dim": _np(sd[c_proj]).shape[0],
        "image_resolution": 224,
        "attn_unpool": not any(k.startswith("model.attnpool.q_proj.") for k in sd),
        "use_bias": any(k.endswith(".bias") and ("proj" in k or ".conv" in k) for k in sd),
    }


def _reference_scope(scope):
    """The port's module path -> the reference's (layer1_0 -> layer1.0;
    the downsample: 0 the avg-pool, 1 the conv, 2 the norm)."""
    out = []
    for s in scope:
        if s.startswith("layer") and "_" in s:
            out += s.split("_")
        elif s == "downsample_conv":
            out += ["downsample", "1"]
        elif s == "downsample_norm":
            out += ["downsample", "2"]
        else:
            out.append(s)
    return out


def clip_trained_student_to_variables(net, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of the student ``net`` from a TRAINED checkpoint of the
    reference's ``BcosifyNetwork(ModifiedResNet)`` (convs as B-cos layers
    with ``.linear.weight``, uncentered BNs with running statistics, c_proj
    B-cosified, q/k/v plain). Strict: every entry but the BNs'
    running_mean and num_batches_tracked maps onto the net."""
    flat, used = {}, set()
    for name, target in net.state_dict().items():
        *scope, leaf = name.split(".")
        tp = "model." + ".".join(_reference_scope(scope[1:]))
        if leaf == "num_batches_tracked":
            flat[name] = np.zeros(tuple(target.shape), np.int32)
            continue
        if leaf == "weight" and scope[-1].endswith("proj"):
            key = tp + (".linear.weight" if scope[-1] == "c_proj" else ".weight")
            cands = [key]
        elif leaf == "weight" and target.dim() == 4:
            cands = [f"{tp}.linear.weight"]
        else:
            cands = [f"{tp}.{leaf}", f"{tp}.linear.{leaf}"]
        key = next((c for c in cands if c in sd), None)
        if key is None:
            raise KeyError(f"{cands[0]} not in the checkpoint")
        used.add(key)
        arr = _np(sd[key])
        flat[name] = np.ascontiguousarray(arr.T) if target.dim() == 2 else arr
    unused = sorted(k for k in set(sd) - used
                    if not k.endswith((".running_mean", ".num_batches_tracked")))
    if unused:
        raise KeyError(f"checkpoint entries that map onto nothing: {unused[:10]}")
    return fill_state_dict(net, flat)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------
def _frozen(module: torch.nn.Module, dev) -> torch.nn.Module:
    return module.to(dev).eval().requires_grad_(False)


def _config(sd, cfg):
    if cfg is not None:
        return cfg
    if sd is not None:
        return clip_model.config_from_state_dict(sd)
    return clip_model.clip_rn50_config()


def build_clip_text(sd: Optional[Mapping[str, Any]] = None, cfg: Optional[dict] = None, *,
                    device=None, seed: int = 0) -> clip_model.TextTransformer:
    """The text tower of ``cfg`` (default: the checkpoint's, else CLIP-RN50's)
    in eval mode on ``device`` (default the GPU), from the checkpoint ``sd``
    or at random init from ``seed``."""
    dev = resolve_device(device)
    cfg = _config(sd, cfg)
    text = clip_model.TextTransformer(
        vocab_size=cfg["vocab_size"], context_length=cfg["context_length"],
        width=cfg["transformer_width"], heads=cfg["transformer_heads"],
        layers=cfg["transformer_layers"], embed_dim=cfg["embed_dim"],
        generator=torch.Generator().manual_seed(seed))
    if sd is not None:
        text.load_state_dict(clip_text_to_variables(text, sd))
    return _frozen(text, dev)


def _check_resnet(cfg) -> None:
    if not isinstance(cfg["vision_layers"], (tuple, list)):
        raise NotImplementedError(f"a CLIP ViT tower: it comes with {clip_model.VIT_SLICE}")


def build_clip_teacher_visual(sd: Optional[Mapping[str, Any]] = None,
                              cfg: Optional[dict] = None, *, device=None,
                              seed: int = 0) -> clip_model.ModifiedResNet:
    """The frozen teacher image tower (ModifiedResNet, the standard attention
    pool, 3-channel input) in eval mode on ``device``, from ``sd`` or at
    random init from ``seed``."""
    dev = resolve_device(device)
    cfg = _config(sd, cfg)
    _check_resnet(cfg)
    visual = clip_model.ModifiedResNet(
        layers=tuple(cfg["vision_layers"]), output_dim=cfg["embed_dim"],
        heads=cfg["vision_width"] * 32 // 64, input_resolution=cfg["image_resolution"],
        width=cfg["vision_width"], attnpool="standard",
        generator=torch.Generator().manual_seed(seed))
    if sd is not None:
        visual.load_state_dict(clip_visual_teacher_to_variables(visual, sd))
    return _frozen(visual, dev)


def build_bcosified_clip_visual(model_config: Dict[str, Any],
                                sd: Optional[Mapping[str, Any]] = None,
                                cfg: Optional[dict] = None, *, device=None,
                                seed: Optional[int] = None) -> BcosifyNetwork:
    """The student: BcosifyNetwork(B-cosified ModifiedResNet) with CLIP's
    6-channel Normalize and no logit layer, in eval mode on ``device``
    (default the GPU; raises without one unless device="cpu"). From the
    OpenAI checkpoint ``sd``, or at random init from ``seed`` (default:
    model_config's "seed", else 0). ``cfg`` overrides the architecture
    (e.g. a small test net)."""
    dev = resolve_device(device)
    cfg = _config(sd, cfg)
    _check_resnet(cfg)
    bargs = model_config.get("bcosify_args", {}) or {}
    b = float((model_config.get("bcos_args", {}) or {}).get("b", 2))
    use_bias = bool(bargs.get("use_bias", False))
    attn_unpool = bool(model_config.get("attn_unpool", False))
    visual = clip_model.ModifiedResNet(
        layers=tuple(cfg["vision_layers"]), output_dim=cfg["embed_dim"],
        heads=cfg["vision_width"] * 32 // 64, input_resolution=cfg["image_resolution"],
        width=cfg["vision_width"], in_channels=6, conv_layer=partial(BcosifyConv2d, b=b),
        norm_layer=BatchNormUncentered2d if use_bias else NoBias(BatchNormUncentered2d),
        attnpool="bcos_unpool" if attn_unpool else "bcos",
        attnpool_linear_layer=partial(PlainLinear, use_bias=use_bias),
        attnpool_c_proj_layer=partial(BcosifyLinear, b=b, use_bias=use_bias),
        generator=_generator(model_config, seed))
    mean, std = normalization_for(clip_kd=True,
                                  bfy_mean_zero=bool(model_config.get("bfy_mean_zero", False)))
    net = BcosifyNetwork(visual, with_logit_layer=False, mean=mean, std=std)
    if sd is not None:
        net.load_state_dict(clip_visual_student_to_variables(
            net, sd, attn_unpool=attn_unpool, use_bias=use_bias))
    return _frozen(net, dev)
