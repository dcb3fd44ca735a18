"""OpenAI CLIP checkpoints into the port, and the B-cosified CLIP builders
(counterpart of ``bcosification_tpu/bcosify/clip_import.py``).

- The text tower and the frozen teacher image tower take the checkpoint as
  it is (linear weights transposed to the port's (in, out) layout).
- The student (``BcosifyNetwork(ModifiedResNet)``) applies the reference's
  B-cosification: the stem conv doubled to the 6 AddInverse channels,
  every BN uncentered (its bias folded and kept only with
  ``bcosify_args.use_bias``), the attention pool's q/k/v kept plain and
  c_proj B-cosified (b=2), biases and the positional embedding nulled.
- The ViT student (``BcosifyNetwork(CLIPVisionTransformer)``) applies the
  same recipe with the ViT rules: the patchify conv doubled to [w, -w] / 2
  (exact on the [z, -z] input), out_proj, c_fc and c_proj B-cosified (b=2)
  with their biases dropped, the q/k/v projection kept plain with its bias
  zeroed (not removed), the QuickGELU gate detached in explanation mode;
  the class and positional embeddings, the LayerNorms and ``proj`` as they
  are.

Each import is strict within the checkpoint's part that it reads (the keys
under ``visual.`` for an image tower, the others but ``logit_scale`` for the
text tower): a key the model needs and does not find, a key that maps onto
nothing (beside the entries the conversion drops) or a shape the model does
not have raises.
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
    "clip_visual_vit_teacher_to_variables",
    "clip_visual_vit_student_to_variables",
    "build_bcosified_clip_vit_visual",
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


    def layer_norm(self, src: str, dst: str) -> None:
        self.copy(f"{src}.weight", f"{dst}.weight")
        self.copy(f"{src}.bias", f"{dst}.bias")

    def resblocks(self, src: str, dst: str, layers: int, *, null_in_bias: bool = False,
                  bias: bool = True) -> None:
        """``layers`` residual blocks: q/k/v as one plain (in, out) linear
        (its bias zeroed with ``null_in_bias``), out_proj, c_fc and c_proj
        (their biases only with ``bias``), ln_1 and ln_2."""
        for i in range(layers):
            s, d = f"{src}.{i}", f"{dst}{i}"
            self.flat[f"{d}.attn_in_proj.weight"] = np.ascontiguousarray(
                self.take(f"{s}.attn.in_proj_weight").T)
            in_bias = self.take(f"{s}.attn.in_proj_bias")
            self.flat[f"{d}.attn_in_proj.bias"] = (np.zeros_like(in_bias) if null_in_bias
                                                   else in_bias)
            for name, scope in (("attn.out_proj", "attn_out_proj"), ("mlp.c_fc", "mlp_c_fc"),
                                ("mlp.c_proj", "mlp_c_proj")):
                self.linear(f"{s}.{name}", f"{d}.{scope}", bias=bias)
            for ln in ("ln_1", "ln_2"):
                self.layer_norm(f"{s}.{ln}", f"{d}.{ln}")


def clip_text_to_variables(text: torch.nn.Module, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of the port's ``TextTransformer`` ``text`` from an
    OpenAI checkpoint: the embeddings, the resblocks, ln_final and the
    text projection."""
    imp = _ClipImport(sd, visual=False, fold_bn_bias=False, use_bias=True)
    for name in ("positional_embedding", "text_projection"):
        imp.copy(name, name)
    imp.copy("token_embedding.weight", "token_embedding")
    imp.resblocks("transformer.resblocks", "resblocks_", text.num_layers)
    imp.layer_norm("ln_final", "ln_final")
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


def _visual_vit_entries(imp: _ClipImport, layers: int, scope: str, *, bcosified: bool,
                        use_bias: bool = True) -> list:
    """The CLIP ViT tower's entries (visual.conv1, the embeddings, ln_pre,
    the resblocks, ln_post, proj). ``bcosified``: the patchify conv doubled
    to [w, -w] / 2 and, without ``use_bias``, the q/k/v bias zeroed and the
    other linears' biases dropped. Returns the keys the conversion drops."""
    w = imp.take("visual.conv1.weight")
    imp.flat[f"{scope}conv1.weight"] = P.add_channels_conv_weight(w) if bcosified else w
    for name in ("class_embedding", "positional_embedding", "proj"):
        imp.copy(f"visual.{name}", f"{scope}{name}")
    imp.layer_norm("visual.ln_pre", f"{scope}ln_pre")
    imp.layer_norm("visual.ln_post", f"{scope}ln_post")
    null_bias = bcosified and not use_bias
    imp.resblocks("visual.transformer.resblocks", f"{scope}resblocks_", layers,
                  null_in_bias=null_bias, bias=not null_bias)
    if not null_bias:
        return []
    return [f"visual.transformer.resblocks.{i}.{name}.bias" for i in range(layers)
            for name in ("attn.out_proj", "mlp.c_fc", "mlp.c_proj")]


def clip_visual_vit_teacher_to_variables(visual, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of the frozen ViT teacher ``visual`` (a
    CLIPVisionTransformer) from an OpenAI checkpoint, as it is."""
    imp = _ClipImport(sd, visual=True, fold_bn_bias=False, use_bias=True)
    _visual_vit_entries(imp, visual.num_layers, "", bcosified=False)
    return imp.finish(visual)


def clip_visual_vit_student_to_variables(net, sd: Mapping[str, Any], *,
                                         use_bias: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of the ViT student ``net``
    (BcosifyNetwork(CLIPVisionTransformer)) from an OpenAI checkpoint,
    B-cosified (``_visual_vit_entries``)."""
    imp = _ClipImport(sd, visual=True, fold_bn_bias=False, use_bias=use_bias)
    droppable = _visual_vit_entries(imp, net.model.num_layers, "model.", bcosified=True,
                                    use_bias=use_bias)
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


def _is_vit(cfg) -> bool:
    return not isinstance(cfg["vision_layers"], (tuple, list))


def _vit(cfg, generator, **kw) -> clip_model.CLIPVisionTransformer:
    return clip_model.CLIPVisionTransformer(
        input_resolution=cfg["image_resolution"], patch_size=cfg["vision_patch_size"],
        width=cfg["vision_width"], layers=cfg["vision_layers"],
        heads=cfg["vision_width"] // 64, output_dim=cfg["embed_dim"], generator=generator,
        **kw)


def build_clip_teacher_visual(sd: Optional[Mapping[str, Any]] = None,
                              cfg: Optional[dict] = None, *, device=None, seed: int = 0):
    """The frozen teacher image tower (ModifiedResNet with the standard
    attention pool, or CLIPVisionTransformer; 3-channel input) in eval mode
    on ``device``, from ``sd`` or at random init from ``seed``."""
    dev = resolve_device(device)
    cfg = _config(sd, cfg)
    generator = torch.Generator().manual_seed(seed)
    if _is_vit(cfg):
        visual = _vit(cfg, generator)
        to_variables = clip_visual_vit_teacher_to_variables
    else:
        visual = clip_model.ModifiedResNet(
            layers=tuple(cfg["vision_layers"]), output_dim=cfg["embed_dim"],
            heads=cfg["vision_width"] * 32 // 64, input_resolution=cfg["image_resolution"],
            width=cfg["vision_width"], attnpool="standard", generator=generator)
        to_variables = clip_visual_teacher_to_variables
    if sd is not None:
        visual.load_state_dict(to_variables(visual, sd))
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
    if _is_vit(cfg):
        raise ValueError("build_bcosified_clip_visual builds the ModifiedResNet student: a "
                         "ViT configuration takes build_bcosified_clip_vit_visual")
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


def build_bcosified_clip_vit_visual(model_config: Dict[str, Any],
                                    sd: Optional[Mapping[str, Any]] = None,
                                    cfg: Optional[dict] = None, *, device=None,
                                    seed: Optional[int] = None) -> BcosifyNetwork:
    """The ViT student: BcosifyNetwork(B-cosified CLIPVisionTransformer) with
    CLIP's 6-channel Normalize and no logit layer, in eval mode on ``device``
    (default the GPU). b=2 BcosifyConv2d patchify conv (no bias) and
    BcosifyLinear out_proj / c_fc / c_proj (biases with
    ``bcosify_args.use_bias``), the gate-detaching QuickGELU, the per-token
    head with ``attn_unpool``. From the OpenAI checkpoint ``sd`` (the
    architecture read from it), or at random init from ``seed`` (default:
    model_config's "seed", else 0) with ``cfg`` (``clip_vit_config``)."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else clip_model.config_from_state_dict(sd)
    if not _is_vit(cfg):
        raise ValueError("build_bcosified_clip_vit_visual needs a ViT configuration")
    bargs = model_config.get("bcosify_args", {}) or {}
    b = float((model_config.get("bcos_args", {}) or {}).get("b", 2))
    use_bias = bool(bargs.get("use_bias", False))
    visual = _vit(cfg, _generator(model_config, seed), in_channels=6,
                  conv_layer=partial(BcosifyConv2d, b=b),
                  linear_layer=partial(BcosifyLinear, b=b, use_bias=use_bias),
                  act_layer=partial(clip_model.QuickGELU, detach_gate=True),
                  unpool=bool(model_config.get("attn_unpool", False)))
    mean, std = normalization_for(clip_kd=True,
                                  bfy_mean_zero=bool(model_config.get("bfy_mean_zero", False)))
    net = BcosifyNetwork(visual, with_logit_layer=False, mean=mean, std=std)
    if sd is not None:
        net.load_state_dict(clip_visual_vit_student_to_variables(net, sd, use_bias=use_bias))
    return _frozen(net, dev)
