"""Render the probe-sweep dataframe as the paper's LaTeX scaling table.

Mirrors `CLIP_benchmark/probe_benchmark/generate_table.py`: per
(model, pretrained, samples_seen) group, the VTAB column is the 19-set
average of best full-shot probe accuracy; ImageNet/CIFAR-100 get one
column per shot count (10/25/full), each the best over the lr/epoch grid.
"""
from __future__ import annotations

import argparse

from bcosification_tpu_torch.clip_benchmark.probe_benchmark.scaling_experiments import VTAB_DATASETS

HEADLINE_DATASETS = ["imagenet1k-unverified", "cifar100"]


def build_table(df):
    import pandas as pd

    group_cols = [c for c in ("model", "pretrained", "samples_seen_pretty")
                  if c in df]
    all_info, cols = [], []
    first = True
    for _, g in df.groupby(group_cols):
        total = sum(
            g[(g.dataset == d) & (g.fewshot_k == -1)].lp_acc1.max()
            for d in VTAB_DATASETS
        )
        info = {"VTAB acc": total / len(VTAB_DATASETS)}
        if first:
            cols.append("VTAB acc")
        for d in HEADLINE_DATASETS:
            for k in (10, 25, -1):
                info[f"{d}: {k} shot"] = g[
                    (g.dataset == d) & (g.fewshot_k == k)
                ].lp_acc1.max()
                if first:
                    cols.append(f"{d}: {k} shot")
        for k in ("model", "pretrained", "upstream_dataset", "gmacs_total",
                  "samples_seen_pretty"):
            if k in g:
                info[k] = g[k].values[0]
        all_info.append(info)
        first = False
    return pd.DataFrame(all_info), cols


def main(argv=None):
    import pandas as pd

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default="probe_benchmark/scaling_experiment_data2.json")
    a = p.parse_args(argv)

    df, cols = build_table(pd.read_json(a.input))
    sort_cols = [c for c in ("model", "samples_seen_pretty", "upstream_dataset")
                 if c in df]
    df = df.sort_values(by=sort_cols)
    columns = sort_cols + cols
    formatters = {ds: (lambda x: f"{100 * x:.2f}") for ds in cols}
    print(df.to_latex(columns=columns, formatters=formatters))


if __name__ == "__main__":
    main()
