"""Linear-probe scaling sweep: 13 OpenCLIP towers x (ImageNet, CIFAR-100,
19 VTAB sets) x {10, 25, full}-shot x 3 lrs x 3 epoch budgets.

Thin runner over ``bcosification_tpu_torch.clip_benchmark.cli.run`` — the grid
and skip rules are the reference's (`CLIP_benchmark/probe_benchmark/scaling_experiments.py:
1-79`); model/dataset availability is whatever the local builder serves.
``--dry_run`` prints the grid without executing.
"""
from __future__ import annotations

import argparse

from bcosification_tpu_torch.clip_benchmark.probe_benchmark.common import run_probe_grid

MODELS = [
    "ViT-B-32-quickgelu,laion400m_e32",
    "ViT-B-32,openai",
    "ViT-B-32,laion2b_s34b_b79k",
    "ViT-B-16,laion400m_e32",
    "ViT-B-16-plus-240,laion400m_e32",
    "ViT-B-16,openai",
    "ViT-L-14-336,openai",
    "ViT-L-14,openai",
    "ViT-B-32,laion2b_e16",
    "ViT-L-14,laion400m_e32",
    "ViT-L-14,laion2b_s32b_b82k",
    "ViT-H-14,laion2b_s32b_b79k",
    "ViT-g-14,laion2b_s12b_b42k",
]

VTAB_DATASETS = [
    "vtab/caltech101",
    "vtab/cifar10",
    "vtab/cifar100",
    "vtab/clevr_count_all",
    "vtab/clevr_closest_object_distance",
    "vtab/diabetic_retinopathy",
    "vtab/dmlab",
    "vtab/dsprites_label_orientation",
    "vtab/dsprites_label_x_position",
    "vtab/dtd",
    "vtab/eurosat",
    "vtab/kitti_closest_vehicle_distance",
    "vtab/flowers",
    "vtab/pets",
    "vtab/pcam",
    "vtab/resisc45",
    "vtab/smallnorb_label_azimuth",
    "vtab/smallnorb_label_elevation",
    "vtab/svhn",
]

DATASETS = ["imagenet1k-unverified", "cifar100"] + VTAB_DATASETS

KS = [10, 25, -1]
LRS = [0.1, 0.01, 0.001]
EPOCH_VALS = [10, 20, 40]
BATCH_SIZES = [32 * 8]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", default="probe_benchmark/data")
    p.add_argument(
        "--dataset_root",
        default="datasets/{name}",
        help="per-dataset root; {name} is the dataset's last path component",
    )
    p.add_argument("--models", nargs="+", default=MODELS)
    p.add_argument("--datasets", nargs="+", default=DATASETS)
    p.add_argument("--model_type", default="standard_clip")
    p.add_argument("--dry_run", action="store_true")
    a = p.parse_args(argv)

    return run_probe_grid(
        models=a.models,
        datasets=a.datasets,
        ks=KS,
        lrs=LRS,
        epoch_vals=EPOCH_VALS,
        batch_sizes=BATCH_SIZES,
        data_dir=a.data_dir,
        dataset_root_fn=lambda d: a.dataset_root.format(name=d.split("/")[-1]),
        skip_vtab_k25=True,
        model_type=a.model_type,
        dry_run=a.dry_run,
    )


if __name__ == "__main__":
    outs = main()
    print(f"{len(outs)} grid points")
