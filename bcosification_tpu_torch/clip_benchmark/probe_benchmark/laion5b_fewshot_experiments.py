"""Few-shot scaling sweep on ImageNet: 9 towers x k∈{1..128} x 4 lrs x 4
epoch budgets, feature extraction shared across grid points.

Thin runner over ``bcosification_tpu_torch.clip_benchmark.cli.run`` mirroring
the reference's LAION-5B few-shot study (`CLIP_benchmark/probe_benchmark/
laion5b_fewshot_experiments.py:1-52`). As there, ``skip_load=True``: the
first grid point of each (model, dataset) extracts and caches features
under ``--feature_root``; the rest refit only the probe head.
"""
from __future__ import annotations

import argparse

from bcosification_tpu_torch.clip_benchmark.probe_benchmark.common import run_probe_grid

MODELS = [
    "ViT-B-32-quickgelu,laion400m_e32",
    "ViT-B-32,openai",
    "ViT-B-32,laion2b_s34b_b79k",
    "ViT-B-16,laion400m_e32",
    "ViT-B-16,openai",
    "ViT-L-14,openai",
    "ViT-L-14,laion400m_e32",
    "ViT-L-14,laion2b_s32b_b82k",
    "ViT-H-14,laion2b_s32b_b79k",
]

DATASETS = ["imagenet1k-unverified"]
KS = [1, 2, 4, 8, 16, 32, 64, 128]
LRS = [0.1, 0.01, 0.001, 0.0001]
EPOCH_VALS = [10, 20, 40, 80]
BATCH_SIZES = [32 * 8]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", default="probe_benchmark/data")
    p.add_argument("--dataset_root", default="datasets/imagenet")
    p.add_argument("--feature_root", default="features")
    p.add_argument("--models", nargs="+", default=MODELS)
    p.add_argument("--datasets", nargs="+", default=DATASETS)
    p.add_argument("--model_type", default="standard_clip")
    p.add_argument("--dry_run", action="store_true")
    a = p.parse_args(argv)

    # the reference iterates epochs outermost here (laion5b_fewshot_
    # experiments.py:28) — grid coverage is identical, outputs are one JSON
    # per point either way, so the shared runner's ordering is kept.
    return run_probe_grid(
        models=a.models,
        datasets=a.datasets,
        ks=KS,
        lrs=LRS,
        epoch_vals=EPOCH_VALS,
        batch_sizes=BATCH_SIZES,
        data_dir=a.data_dir,
        dataset_root_fn=lambda d: a.dataset_root,
        skip_load=True,
        feature_root=a.feature_root,
        model_type=a.model_type,
        dry_run=a.dry_run,
    )


if __name__ == "__main__":
    outs = main()
    print(f"{len(outs)} grid points")
