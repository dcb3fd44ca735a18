"""Export a training checkpoint to a bare, sha-stamped weights file
(counterpart of the repository's ``scripts/strip_checkpoints.py``).

    python -m bcosification_tpu_torch.scripts.strip_checkpoints \\
        --experiment_name resnet_50 [--dataset ImageNet] \\
        [--base_network bcosification] [--reload best_any] [--ema] [--no-sha] \\
        [--output_dir weights]

The checkpoint that ``Trainer.fit`` wrote under ``$BCOS_EXPERIMENT_ROOT``
becomes an npz of the registry format (``import_torch_checkpoint.write_npz``:
the JAX package's keys and layouts), named ``<experiment_name>[_ema]``, which
both packages' ``load_model`` read from ``$BCOS_WEIGHTS_DIR`` (the bare name,
or the sha-stamped ``<name>-<sha8>.npz`` without ``--no-sha``). ``--ema`` on
a checkpoint trained without EMA raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

__all__ = ["main"]


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="ImageNet")
    parser.add_argument("--base_network", default="bcosification")
    parser.add_argument("--experiment_name", required=True)
    parser.add_argument("--reload", default="best_any")
    parser.add_argument("--ema", action="store_true", help="export EMA weights")
    parser.add_argument("--no-sha", action="store_true")
    parser.add_argument("--output_dir", default="weights")
    return parser


def main(argv=None, device=None) -> Path:
    """Run the command; the checkpoint loads onto ``device`` (default the GPU)."""
    args = get_parser().parse_args(argv)

    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.scripts.import_torch_checkpoint import write_npz

    experiment = Experiment(args.dataset, args.base_network, args.experiment_name)
    # strict_ema: --ema on a checkpoint trained without EMA must fail, not
    # export the plain weights under an _ema release name
    model = experiment.load_trained_model(args.reload, ema=args.ema, strict_ema=True,
                                          device=device)
    suffix = "_ema" if args.ema else ""
    final = write_npz(model, Path(args.output_dir), f"{args.experiment_name}{suffix}",
                      sha_suffix=not args.no_sha)
    print(f"wrote {final}")
    return final


if __name__ == "__main__":
    main()
