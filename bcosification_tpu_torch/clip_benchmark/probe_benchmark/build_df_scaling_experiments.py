"""Assemble the probe-sweep JSONs into one scaling-law dataframe.

Mirrors `CLIP_benchmark/probe_benchmark/build_df_scaling_experiments.py`:
one row per grid point, metrics flattened in, joined (when the CSVs are
supplied) with per-model compute (image MACs, ref `clip_table_2.csv`) and
pre-training scale (total GMACs / samples seen, ref `openclip_results.csv`).
Both joins are optional here — the CSVs are published OpenCLIP measurement
tables the zero-egress pod does not bundle; rows simply omit those columns
when absent.
"""
from __future__ import annotations

import argparse
import json
import os

from bcosification_tpu_torch.clip_benchmark.probe_benchmark import scaling_experiments as sweep


def _upstream_dataset(pretrained: str) -> str:
    if "2b" in pretrained:
        return "LAION-2B"
    if "laion" in pretrained:
        return "LAION-400M"
    return "CLIP-WIT"


def build_rows(data_dir, models=None, datasets=None, compute_csv=None,
               openclip_csv=None, strict=True):
    import pandas as pd

    models = models or sweep.MODELS
    datasets = datasets or sweep.DATASETS
    compute_df = pd.read_csv(compute_csv) if compute_csv else None
    mdf = pd.read_csv(openclip_csv) if openclip_csv else None

    rows = []
    for dataset in datasets:
        for model_info in models:
            model, pretrained = model_info.split(",")
            for epochs in sweep.EPOCH_VALS:
                for k in sweep.KS:
                    if k >= 25 and dataset.startswith("vtab"):
                        continue
                    for lr in sweep.LRS:
                        for bs in sweep.BATCH_SIZES:
                            pth = os.path.join(
                                data_dir,
                                f"{model}-{pretrained}-{dataset}-{epochs}-{k}"
                                f"-{lr}-{bs}.json".replace("/", "_"),
                            )
                            if not os.path.exists(pth):
                                if strict:
                                    raise FileNotFoundError(pth)
                                continue
                            row = {
                                "k": k,
                                "lr": lr,
                                "bs": bs,
                                "epochs": epochs,
                                "model": model.replace("-quickgelu", ""),
                                "pretrained": pretrained,
                                "pretrained_short": "laion2b"
                                if "laion2b" in pretrained
                                else pretrained,
                                "pretrained_clean": "LAION"
                                if "laion" in pretrained
                                else "CLIP-WiT",
                                "dataset": dataset,
                                "model_short": model_info.replace(",", " "),
                                "upstream_dataset": _upstream_dataset(pretrained),
                            }
                            if compute_df is not None:
                                sel = compute_df[
                                    compute_df.model == row["model"]
                                ]["image_macts"].values
                                if len(sel):
                                    row["macts"] = sel[0]
                            if mdf is not None:
                                sel = mdf[
                                    mdf.model_fullname == row["model_short"]
                                ]
                                for col in (
                                    "gmacs_total",
                                    "samples_seen",
                                    "samples_seen_pretty",
                                ):
                                    if len(sel) and col in sel:
                                        row[col] = sel[col].values[0]
                            with open(pth) as f:
                                row.update(json.load(f)["metrics"])
                            rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", default="probe_benchmark/data")
    p.add_argument("--output", default="probe_benchmark/scaling_experiment_data2.json")
    p.add_argument("--compute_csv", default=None,
                   help="per-model MACs table (ref clip_table_2.csv)")
    p.add_argument("--openclip_csv", default=None,
                   help="OpenCLIP results table (ref openclip_results.csv)")
    p.add_argument("--allow_missing", action="store_true")
    a = p.parse_args(argv)

    rows = build_rows(
        a.data_dir,
        compute_csv=a.compute_csv,
        openclip_csv=a.openclip_csv,
        strict=not a.allow_missing,
    )
    with open(a.output, "w") as f:
        json.dump(rows, f)
    print(f"{len(rows)} rows -> {a.output}")


if __name__ == "__main__":
    main()
