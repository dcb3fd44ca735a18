"""Minimal end-to-end example: build a B-cosified ResNet-50, run one image,
and render its dynamic-linear explanation (the reference's
``model.explain(x)``) to a PNG (counterpart of the repository's
``examples/explain_minimal.py``).

    python -m bcosification_tpu_torch.examples.explain_minimal [out.png]

It runs on the GPU with no weights and no dataset: random weights from a
seed and a synthetic 224x224 image. A random-init b=2 ResNet-50 contracts
its input to logits of ~1e-20 (they underflow to the logit bias in fp32),
so the BN gammas are calibrated first: doubled until the logits move, then
scaled by a common factor solved from the net's homogeneity in them. With
real weights (``import_torch_checkpoint`` + ``$BCOS_WEIGHTS_DIR``), skip
that step.
"""
from __future__ import annotations

import math
import sys
from typing import Any, Dict, List

import numpy as np
import torch

MODEL_CONFIG = {
    "name": "resnet50",
    "bcosify_args": {"fix_b": True, "use_bias": False, "norm_layer": "BnUncV2",
                     "gap": True, "act_layer": True},
    "bcos_args": {"b": 2},
}
LOGIT_BIAS = -math.log(1000 - 1)  # the LogitLayer's offset: magnitudes are net of it

__all__ = ["build", "synthetic_image", "calibrate", "explain_image", "render", "main"]


def build(device=None, seed: int = 0) -> torch.nn.Module:
    """The B-cosified ResNet-50 at random init from ``seed``, in eval mode on
    ``device`` (default the GPU)."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    return build_bcosified_resnet(MODEL_CONFIG, None, device=device, seed=seed)


def synthetic_image(size: int = 224, seed: int = 0) -> torch.Tensor:
    """A random RGB image [1, size, size, 3] made with numpy from ``seed``,
    AddInverse-encoded to [1, size, size, 6] ([r, g, b, 1-r, 1-g, 1-b])."""
    from bcosification_tpu_torch.data.transforms import AddInverse

    rgb = np.random.default_rng(seed).random((1, size, size, 3), dtype=np.float32)
    return torch.from_numpy(AddInverse()(rgb))


def _gammas(net: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The per-channel norm weights (every 1-D ``weight``)."""
    return [p for name, p in net.named_parameters()
            if name.rsplit(".", 1)[-1] == "weight" and p.dim() == 1]


SOLVES = 20  # the JAX example's 10 leave a full-width ResNet-50 at 0.25, short of its range


def calibrate(net: torch.nn.Module, x: torch.Tensor, logit_bias: float = LOGIT_BIAS) -> float:
    """Scale the BN gammas in place until max |logit - logit_bias| on x lies
    in (0.5, 50); returns that magnitude. First every gamma is doubled (up
    to 8 times) until the logits leave the bias; then, the net being about
    1-homogeneous in each gamma, a common factor f on n gammas scales the
    logits by ~f^n, so f = (5 / magnitude)^(1/n) (up to SOLVES solves).

    The identity paths make a ResNet-50 respond to the common factor with an
    exponent of ~n/6, so each solve closes only part of the gap: the JAX
    example stops after 10 solves, which at full width and seed 0 leaves the
    magnitude at 0.25. The steps are the JAX example's; only the cap is
    higher, so wherever the JAX loop reaches the range the two agree."""
    gammas = _gammas(net)
    x = x.to(gammas[0].device)

    def magnitude() -> float:
        with torch.no_grad():
            return float((net(x) - logit_bias).abs().max())

    def scale(factor: float) -> float:
        with torch.no_grad():
            for g in gammas:
                g.mul_(factor)
        return magnitude()

    mag = magnitude()
    for _ in range(8):
        if mag > 0.0:
            break
        mag = scale(2.0)
    for _ in range(SOLVES):
        if 0.5 < mag < 50.0:
            break
        mag = scale((5.0 / mag) ** (1.0 / len(gammas)))
    return mag


def explain_image(net: torch.nn.Module, x: torch.Tensor, device=None) -> Dict[str, Any]:
    """``explain/core.make_explain_fn`` on x (the fast ResNet pass): the
    prediction, W(x), the contribution map, the logits and the RGBA
    explanation of each image."""
    from bcosification_tpu_torch.explain.core import make_explain_fn

    return make_explain_fn(net)(x, None, device)


def render(rgba: torch.Tensor, out_path: str) -> str:
    """Write an RGBA explanation [H, W, 4] in [0, 1] as a PNG."""
    from PIL import Image

    arr = rgba.detach().float().cpu().numpy()
    Image.fromarray((arr * 255).astype(np.uint8), "RGBA").save(out_path)
    return out_path


def main(out_path: str = "explanation.png", device=None, size: int = 224,
         seed: int = 0) -> Dict[str, Any]:
    """Build, calibrate, explain and render on ``device`` (default the GPU);
    returns the magnitude, the prediction, its logit and the RGBA."""
    net = build(device=device, seed=seed)
    x = synthetic_image(size, seed)
    mag = calibrate(net, x)
    print(f"calibrated |logit - bias| magnitude: {mag:.3g}")
    out = explain_image(net, x, device=device)
    cls = int(out["prediction"][0])
    logit = float(out["logits"][0, cls])
    print(f"prediction: class {cls}  logit {logit:.4f}")
    render(out["explanation"][0], out_path)
    print(f"explanation written to {out_path}")
    return {"magnitude": mag, "prediction": cls, "logit": logit,
            "explanation": out["explanation"][0], "path": out_path}


if __name__ == "__main__":
    main(*sys.argv[1:2])
