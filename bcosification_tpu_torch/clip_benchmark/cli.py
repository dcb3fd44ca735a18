#!/usr/bin/env python
"""CLIP benchmark CLI — arg-compatible with the vendored LAION fork
(`CLIP_benchmark/clip_benchmark/cli.py`) and with the JAX package's
``clip_benchmark/cli.py``: `eval` runs the model x dataset x language product
and dumps one JSON per run; `build` merges JSONs into a CSV. `--distributed`
shards *runs* across processes via WORLD_SIZE/RANK env sniffing
(cli.py:426-443) — not data-parallel eval.

    python -m bcosification_tpu_torch.clip_benchmark.cli eval --dataset wds/<name> \
        --dataset_root <dir> --model_type bcos_clip --model <experiment> ...

`eval` runs on the GPU (``device.resolve_device``: it raises without one);
``main(argv, device="cpu")`` and ``run(args, device="cpu")`` run the plain
versions on the CPU. ``--no_amp`` is parsed and unused, as in the JAX CLI:
images go in as float32.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from copy import copy
from itertools import product

import numpy as np

from bcosification_tpu_torch.clip_benchmark.datasets.builder import (
    build_dataset,
    get_dataset_collate_fn,
    get_dataset_default_task,
)
from bcosification_tpu_torch.clip_benchmark.models import MODEL_TYPES, load_clip
from bcosification_tpu_torch.device import resolve_device


def get_parser_args(argv=None):
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers()

    pe = subparsers.add_parser("eval", help="Evaluate")
    pe.add_argument("--dataset", type=str, default=["cifar10"], nargs="+")
    pe.add_argument("--dataset_root", default="root", type=str)
    pe.add_argument("--split", type=str, default="test")
    pe.add_argument("--test_split", dest="split", action="store", type=str, default="test")
    pe.add_argument("--train_split", type=str, nargs="+", default="train")
    me = pe.add_mutually_exclusive_group()
    me.add_argument("--val_split", default=None, type=str, nargs="+")
    me.add_argument("--val_proportion", default=None, type=float, nargs="+")
    pe.add_argument("--model", type=str, nargs="+", default=["RN50"])
    pe.add_argument("--pretrained", type=str, nargs="+", default=["openai"])
    pe.add_argument("--pretrained_model", type=str, default="", nargs="+")
    pe.add_argument(
        "--task",
        type=str,
        default="auto",
        choices=[
            "zeroshot_classification",
            "zeroshot_retrieval",
            "linear_probe",
            "captioning",
            "image_caption_selection",
            "auto",
        ],
    )
    pe.add_argument("--no_amp", action="store_false", dest="amp", default=True)
    pe.add_argument("--num_workers", default=4, type=int)
    pe.add_argument("--recall_k", default=[5], type=int, nargs="+")
    pe.add_argument("--fewshot_k", default=-1, type=int)
    pe.add_argument("--fewshot_epochs", default=10, type=int)
    pe.add_argument("--fewshot_lr", default=0.1, type=float)
    pe.add_argument("--skip_load", action="store_true")
    pe.add_argument("--distributed", action="store_true")
    pe.add_argument("--seed", default=0, type=int)
    pe.add_argument("--batch_size", default=64, type=int)
    pe.add_argument("--normalize", default=True, type=bool)
    pe.add_argument("--model_cache_dir", default=None, type=str)
    pe.add_argument("--feature_root", default="features", type=str)
    pe.add_argument("--annotation_file", default="", type=str)
    pe.add_argument("--custom_classname_file", default=None, type=str)
    pe.add_argument("--custom_template_file", default=None, type=str)
    pe.add_argument("--dump_classnames", default=False, action="store_true")
    pe.add_argument("--dump_templates", default=False, action="store_true")
    pe.add_argument("--language", default=["en"], type=str, nargs="+")
    pe.add_argument("--output", default="result.json", type=str)
    pe.add_argument("--quiet", dest="verbose", action="store_false")
    pe.add_argument("--save_clf", default=None, type=str)
    pe.add_argument("--load_clfs", nargs="+", default=[], type=str)
    pe.add_argument("--skip_existing", default=False, action="store_true")
    pe.add_argument("--model_type", default="standard_clip", type=str, choices=MODEL_TYPES)
    pe.add_argument("--wds_cache_dir", default=None, type=str)
    # B-cosification arguments (cli.py:68-70)
    pe.add_argument("--cosine_power", default=1, type=int)
    pe.add_argument("--experiment_path", default=None, type=str)
    pe.set_defaults(which="eval")

    pb = subparsers.add_parser("build", help="Build CSV from evaluations")
    pb.add_argument("files", type=str, nargs="+")
    pb.add_argument("--output", type=str, default="benchmark.csv")
    pb.set_defaults(which="build")

    return parser, parser.parse_args(argv)


def _as_list(v):
    if not v:
        return []
    return [v] if not isinstance(v, list) else v


def world_info_from_env():
    """cli.py:426-443."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    global_rank = int(os.environ.get("RANK", 0))
    world_size = int(os.environ.get("WORLD_SIZE", 1))
    return local_rank, global_rank, world_size


def main(argv=None, device=None):
    """``argv``: the arguments (default sys.argv[1:]); ``device``: where
    `eval` runs (default the GPU)."""
    parser, base = get_parser_args(argv)
    if not hasattr(base, "which"):
        parser.print_help()
        return
    if base.which == "eval":
        main_eval(base, device)
    else:
        main_build(base)


def main_build(base):
    rows, fieldnames = [], set()

    def process(path):
        data = json.load(open(path))
        row = dict(data["metrics"])
        row.update({k: v for k, v in data.items() if k != "metrics"})
        row["model_fullname"] = f"{row['model']} {row['pretrained']}"
        fieldnames.update(row)
        rows.append(row)

    for path in base.files:
        if os.path.isdir(path):
            for f in os.listdir(path):
                if f.endswith(".json"):
                    process(os.path.join(path, f))
        else:
            process(path)
    with open(base.output, "w") as f:
        writer = csv.DictWriter(f, fieldnames=sorted(fieldnames))
        writer.writeheader()
        writer.writerows(rows)


def main_eval(base, device=None):
    dev = resolve_device(device)
    models = [(m, p) for m in _as_list(base.model) for p in _as_list(base.pretrained)]
    if base.pretrained_model:
        models = [tuple(pm.split(",")) for pm in _as_list(base.pretrained_model)]
    datasets = _as_list(base.dataset)
    languages = _as_list(base.language)
    runs = list(product(models, datasets, languages))

    if base.distributed:
        _, rank, world = world_info_from_env()
        runs = runs[rank::world]

    for (model, pretrained), dataset, language in runs:
        args = copy(base)
        args.model, args.pretrained = model, pretrained
        args.dataset, args.language = dataset, language
        run(args, dev)


def run(args, device=None):
    dev = resolve_device(device)
    dataset_name = args.dataset
    task = args.task
    if task == "auto":
        task = get_dataset_default_task(dataset_name)

    output = args.output.format(
        dataset=dataset_name.replace("/", "_"),
        pretrained=str(args.pretrained).replace("/", "_"),
        model=str(args.model).replace("/", "_"),
        language=args.language,
        task=task,
    )
    if args.skip_existing and os.path.exists(output):
        print(f"skip existing {output}")
        return

    if getattr(args, "skip_load", False) and task == "linear_probe":
        # ref cli.py:251-253: "for linear probes, when everything is cached,
        # no need to load model" — the probe sweeps pass this for refit-only
        # grid points so the tower isn't rebuilt per point
        bundle = transform = tokenizer = None
    else:
        bundle, transform, tokenizer = load_clip(
            model_type=args.model_type,
            model_name=args.model,
            pretrained=args.pretrained,
            cosine_power=args.cosine_power,
            experiment_path=args.experiment_path,
            device=dev,
        )
    if str(args.model).count("nllb-clip") > 0:
        # ref cli.py:262-264: NLLB-CLIP tokenizers must be pointed at the
        # benchmark language before any text is encoded
        from bcosification_tpu_torch.clip_benchmark.models.nllb_clip import set_language

        set_language(tokenizer, args.language)

    from bcosification_tpu_torch.data.loader import DataLoader

    def make_loader(split):
        ds = build_dataset(
            dataset_name,
            root=args.dataset_root,
            transform=transform,
            split=split,
            task=task,
            custom_classname_file=args.custom_classname_file,
            custom_template_file=args.custom_template_file,
        )
        return ds, DataLoader(
            ds, args.batch_size, num_workers=args.num_workers,
            collate_fn=get_dataset_collate_fn(dataset_name),
        )

    if task == "zeroshot_classification":
        ds, loader = make_loader(args.split)
        from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_classification as m

        classnames = getattr(ds, "classes", None) or []
        templates = getattr(ds, "templates", None) or ["a photo of a {}."]
        # bundle value (parsed from the checkpoint/pretrained spec) wins;
        # --cosine_power is the fallback for bcos models without one
        cosine_power = bundle.cosine_power or (
            args.cosine_power if args.model_type.startswith("bcos") else 0
        )
        metrics = m.evaluate(
            bundle, loader, classnames, templates,
            cosine_power=cosine_power,
            verbose=args.verbose, save_clf=args.save_clf, load_clfs=args.load_clfs,
        )
    elif task == "linear_probe":
        if bundle is None:  # --skip_load: features must be fully cached
            from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as m

            metrics = m.evaluate(
                None, None, None,
                fewshot_k=args.fewshot_k, fewshot_lr=args.fewshot_lr,
                fewshot_epochs=args.fewshot_epochs, batch_size=args.batch_size,
                feature_root=args.feature_root,
                model_id=(
                    f"{args.model_type}_{args.model}_{args.pretrained}"
                ).replace("/", "_"),
                dataset_name=dataset_name.replace("/", "_"),
                seed=args.seed, val_loader=None,
                normalize=bool(args.normalize), verbose=args.verbose, device=dev,
            )
            return _dump_output(args, dataset_name, task, metrics, output)
        train_split = args.train_split if isinstance(args.train_split, str) else args.train_split[0]
        train_ds, train_loader = make_loader(train_split)
        _, test_loader = make_loader(args.split)
        # reference cli.py:350-375: explicit val split, or a seeded carve of
        # val_proportion from the train set (ref uses torch random_split)
        val_loader = None
        if args.val_split is not None:
            vs = args.val_split if isinstance(args.val_split, str) else args.val_split[0]
            _, val_loader = make_loader(vs)
        elif args.val_proportion is not None:
            vp = args.val_proportion if isinstance(args.val_proportion, float) else args.val_proportion[0]
            n = len(train_ds)
            perm = np.random.default_rng(args.seed).permutation(n)
            n_val = max(int(round(n * vp)), 1)

            class _Subset:
                def __init__(self, ds, idx):
                    self.ds, self.idx = ds, idx

                def __len__(self):
                    return len(self.idx)

                def __getitem__(self, i):
                    return self.ds[int(self.idx[i])]

            collate = get_dataset_collate_fn(dataset_name)
            train_loader = DataLoader(_Subset(train_ds, perm[n_val:]), args.batch_size,
                               num_workers=args.num_workers, collate_fn=collate)
            val_loader = DataLoader(_Subset(train_ds, perm[:n_val]), args.batch_size,
                             num_workers=args.num_workers, collate_fn=collate)
        from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as m

        metrics = m.evaluate(
            bundle, train_loader, test_loader,
            fewshot_k=args.fewshot_k, fewshot_lr=args.fewshot_lr,
            fewshot_epochs=args.fewshot_epochs, batch_size=args.batch_size,
            feature_root=args.feature_root,
            # pretrained is part of the cache identity (ref cli.py's
            # model+'-'+pretrained+'-'+dataset feature dir): two checkpoints
            # of one arch must never share cached features
            model_id=(
                f"{args.model_type}_{args.model}_{args.pretrained}"
            ).replace("/", "_"),
            dataset_name=dataset_name.replace("/", "_"),
            seed=args.seed, val_loader=val_loader,
            normalize=bool(args.normalize), verbose=args.verbose, device=dev,
        )
    elif task == "zeroshot_retrieval":
        _, loader = make_loader(args.split)
        from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_retrieval as m

        metrics = m.evaluate(bundle, loader, recall_k_list=args.recall_k)
    elif task == "captioning":
        _, loader = make_loader(args.split)
        from bcosification_tpu_torch.clip_benchmark.metrics import captioning as m

        metrics = m.evaluate(bundle, loader, verbose=args.verbose)
    elif task == "image_caption_selection":
        # ref cli.py:331-333 — sugar_crepe/winoground's auto-default task
        _, loader = make_loader(args.split)
        from bcosification_tpu_torch.clip_benchmark.metrics import image_caption_selection as m

        metrics = m.evaluate(bundle, loader)
    else:
        raise NotImplementedError(f"task {task}")

    return _dump_output(args, dataset_name, task, metrics, output)


def _dump_output(args, dataset_name, task, metrics, output):
    dump = {
        "dataset": dataset_name,
        "model": args.model,
        "pretrained": args.pretrained,
        "task": task,
        "metrics": metrics,
        "language": args.language,
    }
    print(f"{dataset_name} / {args.model} / {task}: {metrics}")
    with open(output, "w") as f:
        json.dump(dump, f)


if __name__ == "__main__":
    main()
