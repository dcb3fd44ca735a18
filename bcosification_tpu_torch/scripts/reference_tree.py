"""Import single modules of the reference B-cosification repository (the
PyTorch code the JAX package and this port reproduce) without importing its
whole ``bcos`` package, whose ``__init__`` needs torchvision.

The tree is a local checkout named by ``$BCOS_REFERENCE_ROOT``. Stub parent
packages point at it, so that only the leaf modules asked for (and their
torch-only imports) run; a minimal ``torchvision.transforms.Normalize`` and
``torchvision.ops.StochasticDepth`` (the reference vendors its own) stand in
for torchvision. Without the tree, every loader raises ModuleNotFoundError.
``validate_release_weights`` uses these as its numerical oracle; nothing
else in the port imports the reference.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types
from pathlib import Path

__all__ = ["reference_root", "reference_available", "load_reference",
           "load_reference_from_scratch_models", "load_reference_bcosify"]


def reference_root() -> Path:
    """The checkout named by $BCOS_REFERENCE_ROOT; raises when it is unset or
    holds no ``bcos`` package."""
    root = os.getenv("BCOS_REFERENCE_ROOT")
    if not root or not (Path(root) / "bcos").is_dir():
        raise ModuleNotFoundError(
            "the reference tree is not available: set BCOS_REFERENCE_ROOT to a local "
            f"checkout of the reference repository (now {root or 'unset'})")
    return Path(root)


def reference_available() -> bool:
    try:
        reference_root()
    except ModuleNotFoundError:
        return False
    return True


def _stub_packages(root: Path):
    for name, path in [
        ("bcos", root / "bcos"),
        ("bcos.modules", root / "bcos" / "modules"),
        ("bcos.modules.norms", root / "bcos" / "modules" / "norms"),
        ("bcos.modules.norms.uncentered_norms",
         root / "bcos" / "modules" / "norms" / "uncentered_norms"),
        ("bcos.training", root / "bcos" / "training"),
        ("bcos.models", root / "bcos" / "models"),
        ("bcos.data", root / "bcos" / "data"),
    ]:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = [str(path)]
            sys.modules[name] = mod


def load_reference(name: str):
    """Import e.g. 'bcos.modules.bcosconv2d' from the reference tree."""
    _stub_packages(reference_root())
    return importlib.import_module(name)


def _stub_torchvision():
    """torchvision.transforms.Normalize with torchvision's semantics
    (channelwise (x - mean) / std), for the reference's root bcosify.py."""
    if "torchvision" in sys.modules:
        return
    import torch

    class Normalize:
        def __init__(self, mean, std, inplace=False):
            self.mean = mean
            self.std = std

        def __call__(self, t):
            mean = torch.as_tensor(self.mean, dtype=t.dtype, device=t.device)
            std = torch.as_tensor(self.std, dtype=t.dtype, device=t.device)
            shape = [1] * (t.ndim - 3) + [-1, 1, 1]
            return (t - mean.view(shape)) / std.view(shape)

    tv = types.ModuleType("torchvision")
    tvt = types.ModuleType("torchvision.transforms")
    tvf = types.ModuleType("torchvision.transforms.functional")
    tvt.Normalize = Normalize
    tvt.functional = tvf
    tv.transforms = tvt
    sys.modules["torchvision"] = tv
    sys.modules["torchvision.transforms"] = tvt
    sys.modules["torchvision.transforms.functional"] = tvf


def load_reference_bcosify():
    """The reference's root-level bcosify.py (its BcosifyNetwork rewriter),
    with its torchvision, CLIP and bcos imports satisfied from the tree."""
    if "bcosify" in sys.modules:
        return sys.modules["bcosify"]
    root = reference_root()
    _stub_packages(root)
    _stub_torchvision()
    for name, path in [("CLIP", root / "CLIP"), ("CLIP.clip", root / "CLIP" / "clip")]:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = [str(path)]
            sys.modules[name] = mod
    mods = sys.modules["bcos.modules"]
    if not hasattr(mods, "LogitLayer"):
        mods.BcosAttentionPool2d = load_reference("bcos.modules.bcosattnpool").BcosAttentionPool2d
        mods.BcosSequential = load_reference("bcos.modules.common").BcosSequential
        mods.LogitLayer = load_reference("bcos.modules.logitlayer").LogitLayer
    unc = sys.modules["bcos.modules.norms.uncentered_norms"]
    if not hasattr(unc, "BatchNormUncentered2d"):
        unc.BatchNormUncentered2d = load_reference(
            "bcos.modules.norms.uncentered_norms.batchnorm_uncentered").BatchNormUncentered2d
    spec = importlib.util.spec_from_file_location("bcosify", root / "bcosify.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bcosify"] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reference_from_scratch_models():
    """The reference's from-scratch model zoo (``bcos.models.resnet`` etc.),
    its ``bcos.modules`` / norms imports and ``torchvision.ops.StochasticDepth``
    satisfied from the tree."""
    _stub_packages(reference_root())
    _stub_torchvision()
    tv = sys.modules["torchvision"]
    if "torchvision.ops" not in sys.modules:
        ops_mod = types.ModuleType("torchvision.ops")
        ops_mod.StochasticDepth = load_reference("bcos.modules.stochastic_depth").StochasticDepth
        tv.ops = ops_mod
        sys.modules["torchvision.ops"] = ops_mod
    mods = sys.modules["bcos.modules"]
    for attr, modname in [("BcosConv2d", "bcos.modules.bcosconv2d"),
                          ("BcosLinear", "bcos.modules.bcoslinear"),
                          ("LogitLayer", "bcos.modules.logitlayer")]:
        if not hasattr(mods, attr):
            setattr(mods, attr, getattr(load_reference(modname), attr))
    norms_stub = sys.modules["bcos.modules.norms"]
    if not hasattr(norms_stub, "NoBias"):
        for modname in ("bcos.modules.norms.centered_norms",
                        "bcos.modules.norms.uncentered_norms.batchnorm_uncentered",
                        "bcos.modules.norms.uncentered_norms.allnorm_uncentered",
                        "bcos.modules.norms.uncentered_norms.groupnorm_uncentered",
                        "bcos.modules.norms.uncentered_norms.posnorm_uncentered",
                        "bcos.modules.norms.utils"):
            m = load_reference(modname)
            for a in getattr(m, "__all__", []):
                setattr(norms_stub, a, getattr(m, a))
    mods.norms = norms_stub
    return load_reference("bcos.models.resnet")
