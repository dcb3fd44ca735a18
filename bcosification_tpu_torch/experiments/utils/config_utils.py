"""Config machinery (the port's copy of
``bcosification_tpu/experiments/utils/config_utils.py``): the recursive
``update_config``, the ``configs_cli`` debug CLI, the lookup of (CONFIGS,
get_model) by dataset and base network under ``EXPERIMENTS_PACKAGE``,
``sanitize_config`` through the ``__to_config__`` protocol and the seed
fan-out.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import pprint
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "update_config",
    "get_configs_and_model_factory",
    "sanitize_config",
    "create_configs_with_different_seeds",
    "configs_cli",
]

EXPERIMENTS_PACKAGE = "bcosification_tpu_torch.experiments"


def update_config(config: Dict[str, Any], new_config: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive non-destructive merge: values in new_config override/extend a
    deep copy of config."""
    result = copy.deepcopy(config)

    def _merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                _merge(dst[k], v)
            else:
                dst[k] = v

    _merge(result, new_config)
    return result


def get_configs_and_model_factory(
    dataset: str, base_network: str
) -> Tuple[Dict[str, Any], Callable]:
    """Import EXPERIMENTS_PACKAGE.<dataset>.<base_network> and return
    (CONFIGS, get_model)."""
    base = f"{EXPERIMENTS_PACKAGE}.{dataset}.{base_network}"
    params = importlib.import_module(base + ".experiment_parameters")
    model = importlib.import_module(base + ".model")
    return params.CONFIGS, model.get_model


def sanitize_config(config: Any) -> Any:
    """Make a config JSON/W&B-safe using the __to_config__ protocol."""
    if hasattr(config, "__to_config__"):
        return sanitize_config(config.__to_config__())
    if isinstance(config, dict):
        return {k: sanitize_config(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [sanitize_config(v) for v in config]
    if isinstance(config, (str, int, float, bool)) or config is None:
        return config
    if callable(config):
        return getattr(config, "__name__", repr(config))
    return repr(config)


def create_configs_with_different_seeds(configs: Dict[str, Any], seeds) -> Dict[str, Any]:
    """Fan out configs over seeds: name-seed=N variants."""
    if isinstance(seeds, int):
        seeds = [seeds]
    out = {}
    for name, config in configs.items():
        for seed in seeds:
            new = update_config(config, {"seed": seed})
            out[f"{name}-seed={seed}"] = new
    return out


def configs_cli(configs: Dict[str, Any]) -> None:
    """Debug CLI for experiment_parameters modules: -f NAME / -a / -s."""
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("-f", "--find", help="print the config with this name")
    group.add_argument("-a", "--all", action="store_true", help="list all names")
    group.add_argument("-s", "--summary", action="store_true", help="count")
    args = parser.parse_args()
    if args.all:
        for name in sorted(configs):
            print(name)
    elif args.summary:
        print(f"{len(configs)} configs")
    elif args.find:
        if args.find not in configs:
            raise SystemExit(f"No config named '{args.find}'")
        pprint.pprint(sanitize_config(configs[args.find]))
