"""Validate released checkpoints against the accuracy north stars
(counterpart of the repository's ``scripts/validate_release_weights.py``).

    BCOS_WEIGHTS_DIR=/path/to/weights \\
    python -m bcosification_tpu_torch.scripts.validate_release_weights
        [--names resnet18,densenet121]      # default: every name with a .pth
        [--imagenet /path/to/imagenet]      # adds val top-1/top-5
        [--wds_root /path/to/wds/imagenet1k]  # adds the CLIP zero-shot leg
        [--clip_names <ckpt stems>]         # default: every CLIP-shaped .pth
        [--batch-size 64] [--limit N] [--rtol 1e-3]

For each registry entrypoint with ``<name>.pth`` (a released torch
checkpoint) in the weights dir:

1. the .pth is converted by ``bcosify.release_import`` into the model flavour
   the checkpoint carries (``return_model=True``), on the GPU;
2. fixed-tensor logit parity: the reference's own torch model for that
   entrypoint (its ``bcos/models`` factories, from the checkout named by
   ``$BCOS_REFERENCE_ROOT``; ``scripts/reference_tree.py``) loads the SAME
   checkpoint, and the logits of a fixed input are compared (an atol scaled
   by the largest reference logit). Without the reference tree the parity
   fails, and so does the run;
3. with --imagenet: the converted model's val top-1/top-5 through the port's
   own eval transform;
4. with --wds_root: the CLIP zero-shot leg. Every trained B-cos CLIP visual
   .pth is converted and scored through the clip_benchmark zero-shot metric
   over local wds/imagenet1k shards and, with the reference tree, the
   reference's own torch model is scored on the same data with the same
   classifier (``evaluate_clip_zeroshot``: within 0.1 %).

Exit code 0 iff every validated entrypoint passes parity and every CLIP
checkpoint its zero-shot leg; an explicit --clip_names without a usable
--wds_root exits 1; a weights dir with nothing to validate exits 0.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ["build_reference_model", "validate_logit_parity", "evaluate_imagenet",
           "evaluate_clip_zeroshot", "main"]


def build_reference_model(name: str, sd):
    """The reference torch model an entrypoint's released checkpoint was
    saved from, with the checkpoint loaded, in eval mode on the CPU.

    The norm flavour is read from the checkpoint (running statistics ->
    BatchNormUncentered2d, else the family's default position norm), the
    rule ``release_import`` uses."""
    import torch.nn as nn
    from functools import partial

    from bcosification_tpu_torch.scripts.reference_tree import (
        load_reference,
        load_reference_from_scratch_models,
    )

    load_reference_from_scratch_models()
    mods = sys.modules["bcos.modules"]
    norms = sys.modules["bcos.modules.norms"]
    has_stats = any(k.endswith("running_var") for k in sd)
    bnu = norms.NoBias(norms.BatchNormUncentered2d)

    base = name[len("standard_"):] if name.startswith("standard_") else name
    base = base[: -len("_long")] if base.endswith("_long") else base
    kwargs = {}
    if base.startswith(("resnet", "resnext", "wide_resnet")):
        mod = load_reference("bcos.models.resnet")
        if has_stats:
            kwargs["norm_layer"] = bnu
        model = getattr(mod, base)(**kwargs)
    elif base.startswith("densenet"):
        mod = load_reference("bcos.models.densenet")
        if has_stats:
            kwargs["norm_layer"] = bnu
        model = getattr(mod, base)(**kwargs)
    elif base.startswith("vgg"):
        mod = load_reference("bcos.models.vgg")
        kwargs["conv_layer"] = mods.BcosConv2d
        if base.endswith("_bnu"):
            kwargs["norm_layer"] = bnu
        model = getattr(mod, base)(**kwargs)
    elif base.startswith("convnext"):
        mod = load_reference("bcos.models.convnext")
        arch = base[: -len("_bnu")] if base.endswith("_bnu") else base
        if base.endswith("_bnu") or has_stats:
            kwargs["norm_layer"] = bnu
        model = getattr(mod, arch)(**kwargs)
    elif base.startswith(("simple_vit", "vitc")):
        mod = load_reference("bcos.models.vit")
        common = load_reference("bcos.modules.common")
        logitmod = load_reference("bcos.modules.logitlayer")
        if name.startswith("standard_"):
            model = getattr(mod, base)(
                linear_layer=nn.Linear, conv2d_layer=nn.Conv2d, norm_layer=nn.LayerNorm,
                act_layer=nn.GELU, channels=3, norm2d_layer=norms.DetachableGNLayerNorm2d)
        else:
            inner = getattr(mod, base)(
                linear_layer=partial(mods.BcosLinear, b=2, max_out=1),
                conv2d_layer=partial(mods.BcosConv2d, b=2, max_out=1),
                norm_layer=norms.NoBias(norms.DetachableLayerNorm),
                act_layer=nn.Identity, channels=6,
                norm2d_layer=norms.NoBias(norms.DetachableGNLayerNorm2d))
            model = common.BcosSequential(
                inner, logitmod.LogitLayer(logit_bias=math.log(1 / 999)))
    else:
        raise ValueError(f"no reference factory for {name}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model.eval()


def validate_logit_parity(name: str, weights_dir: Path, rtol: float = 1e-3, size: int = 224,
                          device=None):
    """{max_abs_err, max_scaled_err, logit_scale, pred_agree, passed} of the
    converted checkpoint (on ``device``, default the GPU) against the
    reference model (on the CPU) on a fixed input. Raises without a .pth."""
    from bcosification_tpu_torch.bcosify.release_import import (
        convert_release_checkpoint,
        load_torch_state_dict,
    )

    weights_dir = Path(weights_dir)
    pth = weights_dir / f"{name}.pth"
    npz = weights_dir / f"{name}.npz"
    if pth.exists():
        sd = load_torch_state_dict(pth)
    elif npz.exists():
        raise FileNotFoundError(
            f"{name}: only the converted npz is present — logit parity needs "
            f"the original .pth to drive the torch reference side")
    else:
        raise FileNotFoundError(f"{name}: no weights in {weights_dir}")

    # return_model: the conversion may rebuild the norm flavour (BNU stats
    # under a posnorm-default name); the default model would run the wrong norm
    net, _ = convert_release_checkpoint(name, sd, return_model=True, device=device)
    ref = build_reference_model(name, sd)

    channels = 3 if name.startswith("standard_") else 6
    rng = np.random.default_rng(0)
    x = rng.random((2, channels, size, size)).astype(np.float32)
    if channels == 6:
        x[:, 3:] = 1.0 - x[:, :3]  # AddInverse encoding
    with torch.no_grad():
        want = ref(torch.from_numpy(x)).numpy()
        dev = next(net.parameters()).device
        got = net(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(dev)).float().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    abs_err = float(np.abs(got - want).max())
    return {
        "max_abs_err": abs_err,
        "max_scaled_err": abs_err / scale,
        "logit_scale": scale,
        "pred_agree": bool((got.argmax(-1) == want.argmax(-1)).all()),
        "passed": bool(abs_err <= rtol * scale),
    }


def evaluate_imagenet(name: str, weights_dir: Path, imagenet: Path, batch_size: int,
                      limit: int = 0, crop_size: int = 224, device=None):
    """{top1, top5, n}: val accuracy of the converted released checkpoint
    through the port's own eval pipeline, on ``device`` (default the GPU).
    Converts straight from ``<weights_dir>/<name>.pth``: ``load_model`` reads
    npz files only and would score a random init."""
    from bcosification_tpu_torch.bcosify.release_import import convert_release_checkpoint
    from bcosification_tpu_torch.data.datamodules import ImageNetDataModule
    from bcosification_tpu_torch.data.presets import ImageNetClassificationPresetEval

    os.environ.setdefault("IMAGENET_PATH", str(imagenet))
    net, _ = convert_release_checkpoint(name, Path(weights_dir) / f"{name}.pth",
                                        return_model=True, device=device)
    dev = next(net.parameters()).device
    dm = ImageNetDataModule(dict(
        batch_size=batch_size, data_root=str(imagenet), train_transform=None,
        test_transform=ImageNetClassificationPresetEval(
            crop_size=crop_size, is_bcos=not name.startswith("standard_"))))
    dm.setup("test")

    top1 = top5 = n = 0
    for batch in dm.val_dataloader():  # {"image": NHWC, "label"} numpy batches
        with torch.no_grad():
            logits = net(torch.as_tensor(batch["image"]).to(dev)).float().cpu().numpy()
        y = np.asarray(batch["label"])
        order = np.argsort(-logits, axis=-1)[:, :5]
        top1 += int((order[:, 0] == y).sum())
        top5 += int((order == y[:, None]).any(-1).sum())
        n += len(y)
        if limit and n >= limit:
            break
    return {"top1": top1 / n, "top5": top5 / n, "n": n}


def _build_reference_clip_student(sd, cfg):
    """The reference's own BcosifyNetwork(ModifiedResNet) for a trained
    B-cos CLIP checkpoint, with the same state dict loaded (its bcosify
    conversion and the clip factory's nulling pass)."""
    import importlib

    from bcosification_tpu_torch.scripts.reference_tree import load_reference_bcosify

    ref_bcosify = load_reference_bcosify()
    clip_mod = importlib.import_module("CLIP.clip.model")
    visual = clip_mod.ModifiedResNet(
        layers=list(cfg["vision_layers"]), output_dim=cfg["embed_dim"],
        heads=cfg["vision_width"] * 32 // 64, input_resolution=cfg["image_resolution"],
        width=cfg["vision_width"]).float()
    model_config = {
        "weights": "VALIDATE",
        "bcosify_args": {"fix_b": True, "use_bias": cfg["use_bias"], "norm_layer": "BnUncV2",
                         "gap": True, "act_layer": True, "clip_kd": True},
        "bcos_args": {"b": 2},
        "attn_unpool": cfg["attn_unpool"],
        "is_bcos": True,
    }
    ref = ref_bcosify.BcosifyNetwork(visual, model_config, add_channels=True,
                                     logit_layer=False)
    for mod in ref.modules():  # the clip factory's nulling pass
        if hasattr(mod, "bias") and mod.bias is not None and not cfg["use_bias"]:
            mod.bias = None
        if getattr(mod, "positional_embedding", None) is not None:
            mod.positional_embedding = None
    ref.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return ref.eval()


def evaluate_clip_zeroshot(ckpt_path: Path, wds_root: Path, batch_size: int = 64,
                           limit: int = 0, with_reference: bool = True, device=None):
    """The zero-shot leg: a trained B-cos CLIP visual checkpoint, converted
    (``clip_import.clip_trained_student_to_variables``) onto ``device``
    (default the GPU), scored by the clip_benchmark zero-shot metric over
    local wds/imagenet1k shards. With the reference tree the reference's own
    torch model is scored on the same data with the same classifier
    (``delta_vs_reference``). Without local RN50 text weights (or with a
    tower of another width) the text tower is a random init: the delta
    stays exact, the absolute accuracy is flagged meaningless."""
    import importlib

    clip_load_mod = importlib.import_module("bcosification_tpu_torch.clip.load")
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_bcosified_clip_visual,
        build_clip_text,
        clip_trained_student_to_variables,
        infer_clip_student_config,
    )
    from bcosification_tpu_torch.bcosify.release_import import load_torch_state_dict
    from bcosification_tpu_torch.clip.tokenizer import tokenize
    from bcosification_tpu_torch.clip_benchmark.datasets.builder import build_dataset
    from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_classification
    from bcosification_tpu_torch.clip_benchmark.models import ModelBundle, _addinverse_transform
    from bcosification_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    sd = load_torch_state_dict(ckpt_path)
    if "model.conv1.linear.weight" not in sd:
        raise ValueError(f"{ckpt_path}: not a trained B-cos CLIP visual checkpoint "
                         "(missing model.conv1.linear.weight)")
    cfg = infer_clip_student_config(sd)
    model_config = {"bcosify_args": {"use_bias": cfg["use_bias"]}, "bcos_args": {"b": 2},
                    "attn_unpool": cfg["attn_unpool"]}
    vision_cfg = {k: cfg[k] for k in ("vision_layers", "vision_width", "embed_dim",
                                      "image_resolution")}
    net = build_bcosified_clip_visual(model_config, None, vision_cfg, device=dev)
    net.load_state_dict(clip_trained_student_to_variables(net, sd))

    text_sd = clip_load_mod.load_state_dict_file("RN50")
    if text_sd is not None and int(text_sd["text_projection"].shape[-1]) != int(cfg["embed_dim"]):
        import warnings

        warnings.warn(
            f"RN50 text tower embed dim {text_sd['text_projection'].shape[-1]} "
            f"!= visual embed dim {cfg['embed_dim']}; using a random-init "
            "tower of matching width (delta_vs_reference stays exact)")
        text_sd = None
    if text_sd is None:
        from bcosification_tpu_torch.clip.model import clip_rn50_config

        tcfg = dict(clip_rn50_config())
        tcfg["embed_dim"] = int(cfg["embed_dim"])
        text_model = build_clip_text(None, tcfg, device=dev)
    else:
        text_model = build_clip_text(text_sd, device=dev)
    cos_power = 1 if cfg["attn_unpool"] else 0

    def encode_image(images):
        with torch.no_grad():
            return net(images)

    bundle = ModelBundle(encode_image, text_model, tokenize, cos_power, device=dev)
    ds = build_dataset("wds/imagenet1k", root=str(wds_root), transform=_addinverse_transform())
    if limit:
        ds.samples = ds.samples[:limit]
    from bcosification_tpu_torch.data.imagenet import imagenet_classes, imagenet_templates
    from bcosification_tpu_torch.data.loader import DataLoader

    classes = ds.classes or imagenet_classes
    templates = ds.templates or imagenet_templates
    classifier = zeroshot_classification.zero_shot_classifier(bundle, classes, templates)
    logits, target = zeroshot_classification.run_classification(
        bundle, classifier, DataLoader(ds, batch_size, num_workers=2), cos_power)
    acc1, acc5 = zeroshot_classification.accuracy(logits, target, topk=(1, 5))
    out = {
        "zeroshot_acc1": acc1,
        "zeroshot_acc5": acc5,
        "n": int(len(target)),
        "attn_unpool": cfg["attn_unpool"],
        "text_tower": "pretrained" if text_sd is not None else
        "RANDOM-INIT (absolute numbers meaningless; delta still exact)",
    }

    if with_reference:
        try:
            from bcosification_tpu_torch.scripts.reference_tree import reference_available
            from bcosification_tpu_torch.training.zeroshot import zeroshot_predict_logits

            if not reference_available():
                raise RuntimeError("reference tree not mounted")
            ref = _build_reference_clip_student(sd, cfg)
            w = torch.as_tensor(np.asarray(classifier, np.float32))
            preds, targets = [], []
            for images, ys in DataLoader(ds, batch_size, num_workers=2):
                x = torch.from_numpy(np.asarray(images, np.float32).transpose(0, 3, 1, 2))
                with torch.no_grad():
                    feats = ref(x)
                    if feats.dim() == 3:  # unpool: per-location features
                        lg = zeroshot_predict_logits(feats, w, cos_power)
                    else:
                        lg = 100.0 * (feats / feats.norm(dim=-1, keepdim=True)) @ w
                preds.append(lg.numpy())
                targets.append(np.asarray(ys))
            ref_acc1, _ = zeroshot_classification.accuracy(
                np.concatenate(preds), np.concatenate(targets), topk=(1, 5))
            out["reference_acc1"] = ref_acc1
            out["delta_vs_reference"] = acc1 - ref_acc1
            out["zeroshot_within_0p1"] = bool(abs(acc1 - ref_acc1) <= 1e-3)
        except Exception as e:  # noqa: BLE001 — the reference side is best-effort
            out["reference_error"] = f"{type(e).__name__}: {e}"
    return out


def _looks_like_clip_student(pth: Path) -> bool:
    """A trained B-cos CLIP visual checkpoint carries model.conv1.linear.weight."""
    try:
        from bcosification_tpu_torch.bcosify.release_import import load_torch_state_dict

        return "model.conv1.linear.weight" in load_torch_state_dict(pth)
    except Exception:  # noqa: BLE001 — unreadable files just aren't CLIP
        return False


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--weights_dir", default=os.getenv("BCOS_WEIGHTS_DIR"))
    parser.add_argument("--names", default=None, help="comma-separated subset")
    parser.add_argument("--imagenet", default=os.getenv("IMAGENET_PATH"))
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--limit", type=int, default=0, help="cap on eval images")
    parser.add_argument("--rtol", type=float, default=1e-3)
    parser.add_argument("--wds_root", default=os.getenv("WDS_IMAGENET1K_PATH"),
                        help="local wds/imagenet1k shards for the CLIP zero-shot leg "
                        "(skipped when absent)")
    parser.add_argument("--clip_names", default=None,
                        help="comma-separated trained B-cos CLIP checkpoint stems in "
                        "--weights_dir (default: every *.pth whose state dict carries "
                        "model.conv1.linear.weight, i.e. a trained CLIP visual)")
    return parser


def main(argv=None, device=None) -> int:
    """Run the command on ``device`` (default the GPU); returns the exit code."""
    parser = get_parser()
    args = parser.parse_args(argv)
    if not args.weights_dir:
        parser.error("set --weights_dir or $BCOS_WEIGHTS_DIR")
    weights_dir = Path(args.weights_dir)

    from bcosification_tpu_torch.models import pretrained as pretrained_lib

    if args.names:
        names = args.names.split(",")
    else:
        names = [n for n in pretrained_lib.list_available()
                 if (weights_dir / f"{n}.pth").exists()]

    # the CLIP zero-shot leg is skipped without shards only when its
    # checkpoints are discovered: an explicit --clip_names needs them
    clip_failures = []
    clip_names = args.clip_names.split(",") if args.clip_names else []
    wds_ok = bool(args.wds_root) and Path(args.wds_root).exists()
    if clip_names and not wds_ok:
        print(f"--clip_names given but wds_root {args.wds_root or '(unset)'} is missing; "
              f"cannot run the zeroshot contract for {clip_names}", file=sys.stderr)
        return 1
    if wds_ok:
        if not clip_names:
            # the registry stems are the parity loop's: don't read them twice
            registry_stems = set(pretrained_lib.list_available())
            clip_names = [p.stem for p in sorted(weights_dir.glob("*.pth"))
                          if p.stem not in registry_stems and _looks_like_clip_student(p)]
        for cname in clip_names:
            try:
                details = evaluate_clip_zeroshot(weights_dir / f"{cname}.pth",
                                                 Path(args.wds_root), args.batch_size,
                                                 args.limit, device=device)
            except Exception as e:  # noqa: BLE001 — report and continue
                details = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"name": cname, "task": "zeroshot", **details}))
            if "error" in details or details.get("zeroshot_within_0p1") is False:
                clip_failures.append(cname)
    elif args.wds_root:
        print(f"wds_root {args.wds_root} not found; zeroshot leg skipped")

    if not names and not clip_names:
        print(f"no .pth checkpoints in {weights_dir}; nothing to validate")
        return 0

    failures = []
    for name in names:
        try:
            details = validate_logit_parity(name, weights_dir, rtol=args.rtol, device=device)
        except Exception as e:  # noqa: BLE001 — report and continue
            details = {"error": f"{type(e).__name__}: {e}", "passed": False}
        if args.imagenet and details.get("passed"):
            try:
                details["imagenet"] = evaluate_imagenet(
                    name, weights_dir, Path(args.imagenet), args.batch_size, args.limit,
                    device=device)
            except Exception as e:  # noqa: BLE001
                details["imagenet"] = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps({"name": name, **details}))
        if not details.get("passed"):
            failures.append(name)

    if failures or clip_failures:
        print(f"FAILED: {failures + clip_failures}", file=sys.stderr)
        return 1
    print(f"all {len(names)} entrypoints pass logit parity (rtol {args.rtol})"
          + (f"; {len(clip_names)} CLIP checkpoints pass zeroshot" if clip_names else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
