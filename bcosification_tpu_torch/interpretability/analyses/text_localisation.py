"""Text-grounded localisation for B-cosified CLIP image towers (counterpart of
``bcosification_tpu/interpretability/analyses/text_localisation.py``).

A phrase is embedded with the CLIP text tower (prompt-ensembled,
``embed_phrase``); the student tower runs in explanation mode and the score
is the cosine of its features with the phrase (per location for
attn-unpool features, optionally argmax-masked, max-normed or
cosine-power weighted, then averaged); one backward gives W(x) and the
colour explanation (``compute_attributions``). A B-cosified CLIP-RN50
takes the hand-scheduled trunk ``explain/fast_clip.fast_encode_and_vjp``
(K1 forward and K2 backward at its 1x1 convs), a B-cosified CLIP ViT
``explain/fast_clip_vit.fast_encode_and_vjp`` (K3 forward and K2 backward
at its B-cos linears; its unpooled logits lie on the token grid, 14x14 for
ViT-B/16); the head is differentiated with autograd on the features.

    python -m bcosification_tpu_torch.interpretability.analyses.text_localisation \\
        --exp_name <clip experiment> --text_to_localize "a dog" [--random_img_path F]
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain.core import gradient_to_image
from bcosification_tpu_torch.interpretability.analyses.utils import Analyser

__all__ = ["TextLocalisationAnalyser", "embed_phrase", "compute_attributions",
           "argument_parser", "main"]

DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a photo of one {}.",
)


def embed_phrase(text_model, phrase: str, templates=DEFAULT_TEMPLATES) -> torch.Tensor:
    """The unit-norm mean of the unit-norm embeddings of the phrase in each
    template, on the text tower's device."""
    from bcosification_tpu_torch.clip.tokenizer import tokenize

    with torch.no_grad():
        emb = text_model(tokenize([t.format(phrase) for t in templates]))
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    emb = emb.mean(0)
    return emb / torch.linalg.vector_norm(emb)


def _head_score(feats, text_embedding, pool_cosine: int, norm_max_cosine: bool):
    """The features' score: their cosine with the text (the normalisation
    differentiable), per location for attn-unpool features [B, HW, D], whose
    pooling weights (argmax mask, max-norm, power) are detached, then the
    mean over locations."""
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    t = text_embedding.to(feats.device, feats.dtype)
    if feats.dim() == 3:
        logits = feats @ t  # [B, HW]
        if pool_cosine == 0:
            mask = F.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype)
            logits = logits * mask
            # the final max rides over the masked locations; amax spreads the
            # gradient over ties, as jnp.max does
            return logits.amax(-1).sum()
        if norm_max_cosine:
            logits = logits / logits.abs().amax(-1, keepdim=True).detach()
        if pool_cosine > 1:
            logits = logits * (logits.abs() ** (pool_cosine - 1)).detach()
        return logits.mean(-1).sum()
    return (feats @ t).sum()


def compute_attributions(student, text_embedding, image, *, pool_cosine: int = 1,
                         norm_max_cosine: bool = False, smooth: int = 0,
                         alpha_percentile: float = 99.5, device=None) -> Dict:
    """One explanation-mode forward and one backward for the text-grounded
    heatmap of image [1, H, W, 6] (AddInverse) on ``device`` (default the
    GPU): the score, W, the contribution map (raw and clipped at the 99.5th
    percentile of its magnitude, with that range) and the RGBA explanation.
    The cosine score is 0-homogeneous in x (the tower is dynamic-linear in
    explanation mode), so the contributions sum to about 0."""
    from bcosification_tpu_torch.explain.fast_clip import text_pass_for

    if pool_cosine == 0 and norm_max_cosine:
        # the argmax path reshapes to (1, HW), whose dim-0 abs-max is the row
        # itself: dividing gives 0/0 on every masked entry
        raise ValueError("pool_cosine=0 with norm_max_cosine yields NaN "
                         "(reference semantics); use one or the other")
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image).to(dev)

    def head(feats):
        return _head_score(feats, text_embedding, pool_cosine, norm_max_cosine)

    fast = text_pass_for(student)
    if fast is not None:
        feats, vjp = fast.fast_encode_and_vjp(student, image, device=dev)
        feats = feats.detach().requires_grad_(True)
        with torch.enable_grad():
            score = head(feats)
        (ct,) = torch.autograd.grad(score, feats)
        grad = vjp(ct)
    else:
        x = image.detach().requires_grad_(True)
        with torch.enable_grad():
            score = head(student(x, train=False, explain=True))
        (grad,) = torch.autograd.grad(score, x)
    contribs = (image * grad).sum(-1)[0]
    explanation = gradient_to_image(image[0].float(), grad[0].float(), smooth=smooth,
                                    alpha_percentile=alpha_percentile)
    cutoff = torch.quantile(contribs.abs().float().flatten(), 0.995)
    clipped = contribs.clamp(-cutoff, cutoff)
    return {
        "score": float(score.detach()),
        "dynamic_linear_weights": grad,
        "contribution_map": contribs,
        "contribution_map_clipped": clipped,
        "vrange": float(clipped.abs().max()),
        "explanation": explanation,
    }


class TextLocalisationAnalyser(Analyser):
    default_config = dict(
        pool_cosine=1, norm_max_cosine=False, smooth=0, alpha_percentile=99.5,
        templates=DEFAULT_TEMPLATES,
    )

    def __init__(self, student, text_model, device=None, **config):
        super().__init__(**config)
        self.student = student
        self.text_model = text_model
        self.device = resolve_device(device)

    def localise(self, image, phrase: str) -> Dict:
        emb = embed_phrase(self.text_model, phrase, self.config["templates"])
        return compute_attributions(
            self.student, emb, image,
            pool_cosine=self.config["pool_cosine"],
            norm_max_cosine=self.config["norm_max_cosine"],
            smooth=self.config["smooth"],
            alpha_percentile=self.config["alpha_percentile"],
            device=self.device,
        )

    def analysis(self):
        raise NotImplementedError("use .localise(image, phrase) directly")


def argument_parser(add_help: bool = True):
    """The JAX package's flags."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Text-grounded localisation for B-cosified CLIP.",
        add_help=add_help,
    )
    parser.add_argument("--exp_name", type=str, required=True,
                        help="experiment name under ImageNet/"
                             "clip_bcosification, or an experiment path")
    parser.add_argument("--text_to_localize", type=str, required=False,
                        help="comma-separated phrases")
    parser.add_argument("--exp_name_data", type=str, default=None,
                        help="accepted for parity with the JAX package (the "
                             "datamodule comes from the experiment config)")
    parser.add_argument("--image_index", type=int, default=11)
    parser.add_argument("--use_attn_unpool", action="store_true", default=False)
    parser.add_argument("--pool_cosine", type=int, default=1)
    parser.add_argument("--norm_max_cosine", action="store_true", default=False)
    parser.add_argument("--smooth", type=int, default=0)
    parser.add_argument("--random_img_path", type=str, default=None)
    parser.add_argument("--use_class_name", action="store_true", default=False)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--reload", type=str, default="best_any")
    return parser


def _load_image(path: str) -> np.ndarray:
    """An image file -> [1, 224, 224, 6] AddInverse array (bicubic resize of
    the short side to 224, center crop, [0, 1] floats, AddInverse)."""
    from PIL import Image

    from bcosification_tpu_torch.data import transforms as T

    tfm = T.Compose([
        T.Resize(224, interpolation="bicubic"),
        T.CenterCrop(224),
        T.ToFloatArray(),
        T.AddInverse(),
    ])
    with Image.open(path) as img:
        arr = tfm(img.convert("RGB"))
    return np.asarray(arr)[None]


def main(config=None, device=None):
    """The text localisation command on ``device`` (default the GPU; "cpu"
    when asked). The student is the experiment's trained model, or its
    conversion-time init when it has no checkpoint; the text tower is
    OpenAI's from local files, or a random init when none is found."""
    from PIL import Image

    from bcosification_tpu_torch.clip.load import MODEL_CONFIG_CLIP_NAMES
    from bcosification_tpu_torch.clip.load import load as clip_load
    from bcosification_tpu_torch.data.imagenet import imagenet_templates
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    dev = resolve_device(device)
    if config is None:
        config = argument_parser().parse_args()

    if os.path.sep in config.exp_name and os.path.isdir(config.exp_name):
        experiment = Experiment(path=config.exp_name)
    else:
        experiment = Experiment("ImageNet", "clip_bcosification", config.exp_name)
    try:
        student = experiment.load_trained_model(config.reload, device=dev)
    except FileNotFoundError:
        print("No trained checkpoint; using conversion-time init")
        student = experiment.get_model(device=dev)
    # the text tower must match the student's CLIP architecture
    model_cfg = experiment.config.get("model", {})
    clip_name = MODEL_CONFIG_CLIP_NAMES.get(model_cfg.get("name", "resnet50clip"), "RN50")
    _, text_model, _, _ = clip_load(clip_name, device=dev)

    # attn-unpool is a property of the model; the flag cannot retrofit it
    model_unpool = bool(model_cfg.get("attn_unpool", False))
    if config.use_attn_unpool and not model_unpool:
        raise ValueError(
            "--use_attn_unpool given but the experiment was not built with "
            "attn_unpool (model_config['attn_unpool'] is falsy)"
        )
    if model_unpool and not config.use_attn_unpool:
        print(
            "note: experiment uses attn_unpool; applying its cos_power "
            "(pass --use_attn_unpool --pool_cosine to override)"
        )
        config.use_attn_unpool = True
        config.pool_cosine = int(model_cfg.get("cos_power", config.pool_cosine))

    if config.random_img_path:
        image = _load_image(config.random_img_path)
        class_name = os.path.splitext(os.path.basename(config.random_img_path))[0]
    else:
        dm = experiment.get_datamodule()
        dm.setup("test")
        img_arr, label = dm.eval_dataset[config.image_index]
        image = np.asarray(img_arr)[None]
        if image.shape[-1] == 3:
            # the CLIP eval presets stop at [0, 1] RGB (training encodes
            # AddInverse model-side); the student here takes AddInverse input
            image = np.concatenate([image, 1.0 - image], axis=-1)
        from bcosification_tpu_torch.data.categories import imagenet_class_index

        class_name = imagenet_class_index()[str(int(label))][1]

    phrases = (
        [class_name]
        if config.use_class_name
        else [p.strip() for p in (config.text_to_localize or "").split(",") if p.strip()]
    )
    assert phrases, "give --text_to_localize or --use_class_name"

    analyser = TextLocalisationAnalyser(
        student, text_model, device=dev,
        templates=imagenet_templates,
        pool_cosine=config.pool_cosine,
        norm_max_cosine=config.norm_max_cosine,
        smooth=config.smooth,
    )
    save_root = config.save_path or str(getattr(experiment, "save_dir", "."))
    out_dir = os.path.join(
        save_root, "textloc_expl", class_name, f"smooth{config.smooth}"
        + ("_attn_unpool" if config.use_attn_unpool else "")
    )
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for phrase in phrases:
        res = analyser.localise(image, phrase)
        # --smooth feeds the render's alpha channel; the raw-attribution map
        # is percentile-clipped, never smoothed
        stem = os.path.join(out_dir, f"Text_{phrase.replace(' ', '_')}")
        np.savez(
            stem + ".npz",
            contribution_map=res["contribution_map_clipped"].float().cpu().numpy(),
            contribution_map_raw=res["contribution_map"].float().cpu().numpy(),
            vrange=np.asarray(res["vrange"]),
            explanation=res["explanation"].cpu().numpy(),
            score=np.asarray(res.get("score", np.nan)),
        )
        expl = res["explanation"].cpu().numpy()
        rgba = (np.nan_to_num(np.clip(expl, 0, 1)) * 255).astype(np.uint8)
        try:  # the picture is a convenience beside the .npz
            Image.fromarray(rgba, "RGBA").save(stem + ".png")
        except OSError as e:
            print(f"could not write {stem}.png: {e}")
        results[phrase] = res
    print(f"wrote {len(results)} text localisations to {out_dir}")
    return results


if __name__ == "__main__":
    main()
