"""Convert a torch checkpoint (.pth) into the weights-registry npz format
(counterpart of the repository's ``scripts/import_torch_checkpoint.py``).

    python -m bcosification_tpu_torch.scripts.import_torch_checkpoint \\
        --checkpoint resnet50.pth --experiment_name resnet_50 \\
        [--dataset ImageNet] [--base_network bcosification] [--entrypoint NAME] \\
        [--output_dir weights] [--no-sha] [--ema]

The checkpoint is a torchvision-architecture state dict (the bcosification
recipe's starting point), converted through the experiment's bcosify recipe
(channel doubling, the BN bias fold of its bcosify_args). Lightning's
``model.`` / ``ema.module.`` prefixes select ONE weight set first.

npz schema (the registry format, also written by ``strip_checkpoints``):
keys ``params/<module path.../param>`` and ``batch_stats/<...>``, ``/``
joining the path; values numpy arrays in the JAX package's layouts (conv
HWIO, linear (in, out)), so that both packages' ``load_model`` read the file
from ``$BCOS_WEIGHTS_DIR/<entrypoint>[-<sha256[:8]>].npz``.
"""
from __future__ import annotations

import argparse
import hashlib
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables

__all__ = ["load_torch_state_dict", "convert", "flatten_variables", "write_npz", "main"]


def load_torch_state_dict(path: str, use_ema: bool = False) -> Dict[str, Any]:
    """.pth -> flat {name: tensor}, ONE weight set selected by prefix.

    A Lightning checkpoint can hold both a ``model.*`` and an
    ``ema.module.*`` set: ``use_ema`` picks the EMA set, else the model's,
    and the two are never merged. A file with only the other set gives that
    one, with a warning. Nested wrappers (``ema.module.model.*``) are
    stripped fully. The file is read with ``weights_only=True``: plain
    tensors and containers only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]

    def strip_wrappers(k: str) -> str:
        changed = True
        while changed:
            changed = False
            for p in ("model.", "module."):
                if k.startswith(p):
                    k = k[len(p):]
                    changed = True
        return k

    want = "ema.module." if use_ema else "model."
    other = "model." if use_ema else "ema.module."
    keys = list(obj)
    for prefix in (want, other):
        if any(k.startswith(prefix) for k in keys):
            if prefix == other:
                warnings.warn(f"checkpoint has no {want}* keys; using the {other}* weight set")
            return {strip_wrappers(k[len(prefix):]): v for k, v in obj.items()
                    if k.startswith(prefix)}
    return {strip_wrappers(k): v for k, v in obj.items()}


def convert(state_dict, dataset: str, base_network: str, experiment_name: str, *,
            device=None) -> torch.nn.Module:
    """The experiment's B-cosified model, in eval mode on ``device``
    (default the GPU), with ``state_dict`` converted through its bcosify
    recipe (instead of the torchvision weights the experiment's factory
    would load itself)."""
    from bcosification_tpu_torch.bcosify.engine import (
        build_bcosified_densenet,
        build_bcosified_resnet,
    )
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    mc = Experiment(dataset, base_network, experiment_name).model_config
    arch = mc["name"]
    num_classes = mc.get("args", {}).get("num_classes", 1000)
    if arch.startswith(("resnet", "resnext", "wide_resnet")):
        return build_bcosified_resnet(mc, state_dict, num_classes=num_classes, device=device)
    if arch.startswith("densenet"):
        return build_bcosified_densenet(mc, state_dict, num_classes=num_classes, device=device)
    raise ValueError(
        f"unsupported arch {arch!r} — resnet/resnext/densenet checkpoints "
        "convert; ViTs train from scratch in the reference recipe"
    )


def flatten_variables(variables: Union[torch.nn.Module, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """{'params/a/b/c': array} of a model (through ``to_jax_variables``: the
    JAX package's tree and layouts) or of a variables tree, in the JAX
    package's order (keys sorted at every level, as its tree flattening
    sorts them) and C order: the same weights give the same file, sha stamp
    included."""
    tree = to_jax_variables(variables) if isinstance(variables, torch.nn.Module) else variables
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in sorted(node.items()):
            if isinstance(value, Mapping):
                walk(value, prefix + [str(key)])
            else:
                flat["/".join(prefix + [str(key)])] = np.array(value, order="C")

    walk(tree, [])
    return flat


def write_npz(variables, out_dir: Path, name: str, sha_suffix: bool = True) -> Path:
    """Write ``flatten_variables(variables)`` to ``out_dir/<name>.npz``, or
    with ``sha_suffix`` to ``<name>-<sha256 of the file[:8]>.npz``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # np.savez appends '.npz' to names that lack it, so the tmp name ends in .npz
    tmp = out_dir / f"{name}.tmp.npz"
    np.savez(tmp, **flatten_variables(variables))
    if sha_suffix:
        sha = hashlib.sha256(tmp.read_bytes()).hexdigest()[:8]
        final = out_dir / f"{name}-{sha}.npz"
    else:
        final = out_dir / f"{name}.npz"
    tmp.rename(final)
    return final


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help=".pth file")
    parser.add_argument("--dataset", default="ImageNet")
    parser.add_argument("--base_network", default="bcosification")
    parser.add_argument("--experiment_name", required=True)
    parser.add_argument("--entrypoint", default=None,
                        help="registry name for the npz (default: experiment_name)")
    parser.add_argument("--output_dir", default="weights")
    parser.add_argument("--no-sha", action="store_true")
    parser.add_argument("--ema", action="store_true",
                        help="export the ema.module.* weight set")
    return parser


def main(argv=None, device=None) -> Path:
    """Run the command; the conversion runs on ``device`` (default the GPU)."""
    args = get_parser().parse_args(argv)
    sd = load_torch_state_dict(args.checkpoint, use_ema=args.ema)
    net = convert(sd, args.dataset, args.base_network, args.experiment_name, device=device)
    path = write_npz(net, Path(args.output_dir), args.entrypoint or args.experiment_name,
                     sha_suffix=not args.no_sha)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
