"""Explainer registry (counterpart of
``bcosification_tpu/interpretability/explanation_methods/__init__.py``):
``explainer_map`` with its aliases, the per-explainer ``explanation_configs``
and ``get_explainer``."""
from __future__ import annotations

from typing import Any, Dict

from bcosification_tpu_torch.interpretability.explanation_methods.explainers import (
    GB,
    DeepLift,
    ExplainerBase,
    Grad,
    GradCam,
    IntGrad,
    IxG,
    Lime,
    Occlusion,
    Ours,
    OursRelative,
    Rise,
)

__all__ = ["explainer_map", "explanation_configs", "get_explainer"]

explainer_map = {
    "Ours": Ours,
    "OursRelative": OursRelative,
    "IxG": IxG,
    "Grad": Grad,
    "GB": GB,
    "DeepLIFT": DeepLift,
    "DeepLift": DeepLift,
    "IntGrad": IntGrad,
    "GradCam": GradCam,
    "Occlusion": Occlusion,
    "Rise": Rise,
    "RISE": Rise,
    "Lime": Lime,
    "LIME": Lime,
}

explanation_configs: Dict[str, Dict[str, Any]] = {
    "Ours": {},
    "OursRelative": {},
    "IxG": {},
    "Grad": {},
    "GB": {},
    "DeepLIFT": {},
    "IntGrad": {"n_steps": 20},
    "GradCam": {},
    "Occlusion": {"patch_size": 16, "stride": 8},
    "Rise": {"n_masks": 500, "cell_size": 7, "p": 0.5},
    "Lime": {"n_samples": 200, "cell_size": 8},
}


def get_explainer(model, explainer_name: str, *, device=None, **overrides) -> ExplainerBase:
    """The explainer ``explainer_name`` of ``model`` on ``device`` (default
    the GPU), with its preset of ``explanation_configs`` and ``overrides``."""
    if explainer_name not in explainer_map:
        raise ValueError(
            f"Unknown explainer {explainer_name!r}. Available: {sorted(explainer_map)}"
        )
    cfg = dict(explanation_configs.get(explainer_name, {}))
    cfg.update(overrides)
    return explainer_map[explainer_name](model, device, **cfg)
