"""Shared plumbing for the probe_benchmark sweep drivers.

The reference scripts build an eval-args namespace from the CLI parser's
defaults and mutate per grid point before calling ``cli.run`` (ref
`probe_benchmark/scaling_experiments.py:62-78`). Here the same namespace
comes from parsing an empty ``eval`` invocation, so driver and CLI can never
drift apart on defaults.
"""
from __future__ import annotations

import os
from copy import copy
from typing import Iterable, Optional

from bcosification_tpu_torch.clip_benchmark import cli


def eval_args(**overrides):
    """Namespace with the CLI's ``eval`` defaults, plus ``overrides``: the
    namespace a user typing ``cli eval`` would get."""
    _, base = cli.get_parser_args(["eval"])
    for k, v in overrides.items():
        if not hasattr(base, k):
            raise AttributeError(f"unknown eval arg {k!r}")
        setattr(base, k, v)
    return base


def run_probe_grid(
    *,
    models: Iterable[str],
    datasets: Iterable[str],
    ks: Iterable[int],
    lrs: Iterable[float],
    epoch_vals: Iterable[int],
    batch_sizes: Iterable[int],
    data_dir: str,
    dataset_root_fn,
    skip_vtab_k25: bool = False,
    skip_load: bool = False,
    dry_run: bool = False,
    model_type: str = "standard_clip",
    feature_root: Optional[str] = None,
    device=None,
):
    """Drive ``cli.run`` over the probe grid; one JSON per grid point.

    ``models`` entries are "arch,pretrained" pairs (the reference's format);
    existing outputs are skipped so interrupted sweeps resume (ref
    `scaling_experiments.py:66-69`). ``dry_run`` yields the prepared args
    without executing (used by the tests). ``device``: where ``cli.run``
    runs (default the GPU). Returns the list of output paths that were run
    (or would be).
    """
    os.makedirs(data_dir, exist_ok=True)
    done = []
    for dataset in datasets:
        for model_info in models:
            model, pretrained = model_info.split(",")
            for epochs in epoch_vals:
                for k in ks:
                    # the reference skips >=25-shot on VTAB (too few samples
                    # per class in several of its sets)
                    if skip_vtab_k25 and k >= 25 and dataset.startswith("vtab"):
                        continue
                    for lr in lrs:
                        for bs in batch_sizes:
                            out = os.path.join(
                                data_dir,
                                f"{model}-{pretrained}-{dataset}-{epochs}-{k}"
                                f"-{lr}-{bs}.json".replace("/", "_"),
                            )
                            if os.path.exists(out):
                                print(f"skipping - exists: {out}")
                                continue
                            args = eval_args(
                                dataset=dataset,
                                dataset_root=dataset_root_fn(dataset),
                                task="linear_probe",
                                model=model,
                                pretrained=pretrained,
                                output=out,
                                fewshot_k=k,
                                fewshot_epochs=epochs,
                                fewshot_lr=lr,
                                batch_size=bs,
                                skip_load=skip_load,
                                model_type=model_type,
                            )
                            if feature_root is not None:
                                args.feature_root = feature_root
                            done.append(out)
                            if dry_run:
                                continue
                            cli.run(copy(args), device)
                            print(dataset, model, pretrained, epochs, k, lr, bs)
    return done
