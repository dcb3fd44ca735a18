"""Carry the JAX package's weights into the port.

``load_jax_variables(model, variables_np)`` takes a flax variables tree
({"params": ..., "batch_stats": ...}, leaves as numpy arrays) and fills the
port model of the same architecture. The port's module names mirror the
JAX scopes, so a leaf at params/model/layer1_0/conv1/weight is the state
dict entry ``model.layer1_0.conv1.weight``. Conv weights are HWIO in JAX
and OIHW here (a grouped conv's [kh, kw, Cin / groups, Cout] too); every
other leaf (the norms' weights, the position norm's among them, and the
ViTs' (in, out) linear weights) copies as it is. ``to_jax_variables(model)``
is the inverse: parameters go to "params", buffers (the BN running_var and
num_batches_tracked) to "batch_stats".
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["load_jax_variables", "load_jax_npz", "flatten_variables", "to_jax_variables"]


def flatten_variables(variables_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{dotted port name: array} for every leaf of params and batch_stats."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [key])
            else:
                name = ".".join(prefix + [key])
                if name in flat:
                    raise ValueError(f"leaf {name} appears in two collections")
                flat[name] = np.asarray(value)

    for collection in ("params", "batch_stats"):
        walk(variables_np.get(collection, {}), [])
    return flat


def load_jax_variables(model: torch.nn.Module, variables_np: Mapping[str, Any]) -> None:
    """Copy the JAX leaves into ``model`` in place. Raises on a missing,
    extra or mis-shaped leaf."""
    flat = flatten_variables(variables_np)
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise ValueError(f"JAX variables do not match the model: missing {missing}, "
                         f"extra {extra}")
    with torch.no_grad():
        for name, arr in flat.items():
            target = state[name]
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} (as OIHW) vs "
                                 f"model {tuple(target.shape)}")
            target.copy_(torch.as_tensor(np.array(arr)).to(target.dtype))


def to_jax_variables(model: torch.nn.Module) -> Dict[str, Dict[str, Any]]:
    """{"params": ..., "batch_stats": ...} of ``model`` as nested dicts of
    numpy arrays in the JAX layout (OIHW -> HWIO)."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for collection, named in (("params", model.named_parameters()),
                              ("batch_stats", model.named_buffers())):
        for name, t in named:
            arr = t.detach().cpu().numpy()
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            *path, leaf = name.split(".")
            node = out[collection]
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = np.array(arr)
    return out


def load_jax_npz(model: torch.nn.Module, path) -> None:
    """Fill ``model`` from an npz of JAX variables, keyed by their paths
    ("params/model/layer1_0/conv1/weight", as the JAX package's
    ``strip_checkpoints`` and ``evaluate.py --weights`` use)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as loaded:  # plain arrays only: never allow_pickle
        for key in loaded.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = loaded[key]
    load_jax_variables(model, tree)
