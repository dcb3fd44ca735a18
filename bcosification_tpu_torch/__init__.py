"""PyTorch + CUDA port of bcosification_tpu (B-cosification), for NVIDIA
Hopper GPUs. Imports torch and numpy only; the JAX package is its reference.

Public layouts follow the JAX package: activations and explanations are
NHWC ([N, H, W, 6] AddInverse inputs), and weights map one to one onto the
JAX HWIO arrays (bcosify/from_jax.py). Entry points run on the GPU unless
the caller passes ``device="cpu"``.

The submodules and ``BcosModel`` load on first access, so importing the
package builds no kernel and imports no plotting library.
"""
from bcosification_tpu_torch.device import resolve_device

__version__ = "0.3.0"  # keep in sync with pyproject.toml

__all__ = ["resolve_device", "BcosModel", "gradient_to_image", "plot_contribution_map"]

_SUBMODULES = {
    "presets": "bcosification_tpu_torch.data.presets",
    "transforms": "bcosification_tpu_torch.data.transforms",
    "models": "bcosification_tpu_torch.models",
    "pretrained": "bcosification_tpu_torch.models.pretrained",
    "modules": "bcosification_tpu_torch.modules",
    "optim": "bcosification_tpu_torch.optim",
    "settings": "bcosification_tpu_torch.settings",
    "losses": "bcosification_tpu_torch.losses",
    "explain": "bcosification_tpu_torch.explain",
    "clip": "bcosification_tpu_torch.clip",
}


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(_SUBMODULES[name])
    if name in ("BcosModel", "gradient_to_image", "plot_contribution_map"):
        from bcosification_tpu_torch import common

        return getattr(common, name)
    raise AttributeError(name)
