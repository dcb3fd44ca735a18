"""Collapse the full-shot VTAB sweep rows into one averaged row per model.

Mirrors `CLIP_benchmark/probe_benchmark/process_vtab.py`: for each
(model, pretrained) group, take each VTAB set's best full-shot (k=-1)
probe accuracy over the lr/epoch grid, average across the 19 sets, and
emit a synthetic ``dataset="vtab"`` row carrying the group's scale columns.
"""
from __future__ import annotations

import argparse
import json

from bcosification_tpu_torch.clip_benchmark.probe_benchmark.scaling_experiments import VTAB_DATASETS

SCALE_COLS = ["model", "pretrained", "upstream_dataset", "gmacs_total",
              "samples_seen_pretty"]


def vtab_rows(df):
    df = df[df.fewshot_k == -1] if "fewshot_k" in df else df[df.k == -1]
    group_cols = [c for c in ("model", "pretrained", "samples_seen_pretty")
                  if c in df]
    all_info = []
    for _, g in df.groupby(group_cols):
        total = 0.0
        for d in VTAB_DATASETS:
            total += g[g.dataset == d].lp_acc1.max()
        info = {
            "dataset": "vtab",
            "lp_acc1": total / len(VTAB_DATASETS),
            "fewshot_k": -1,
        }
        for k in SCALE_COLS:
            if k in g:
                info[k] = g[k].values[0]
        all_info.append(info)
    return all_info


def main(argv=None):
    import pandas as pd

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default="probe_benchmark/scaling_experiment_data2.json")
    p.add_argument("--output", default="probe_benchmark/scaling_experiment_data_vtab.json")
    a = p.parse_args(argv)

    rows = vtab_rows(pd.read_json(a.input))
    with open(a.output, "w") as f:
        json.dump(rows, f)
    print(f"{len(rows)} rows -> {a.output}")


if __name__ == "__main__":
    main()
