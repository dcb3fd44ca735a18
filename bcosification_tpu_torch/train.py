"""The train command of the port, with the JAX package's ``train.py`` flags:

    python -m bcosification_tpu_torch.train --dataset ImageNet \\
        --base_network bcosification --experiment_name resnet_50 [--amp] \\
        [--fast_dev_run] [--force-no-resume] [--base_directory D] \\
        [--tensorboard_logger] [--wandb_logger] [--explanation_logging] \\
        [--profile_dir P] [--debug]

It runs on the GPU. ``--amp`` trains in bf16 (f32 parameters and optimizer
state); ``--distributed`` and ``--jit`` are accepted and have no effect on
one card. The flags of features that are not ported yet raise, naming the
slice that brings them (``training/trainer.py::UNPORTED_FLAGS``).
Checkpoints and metrics go to ``--base_directory`` or
``$BCOS_EXPERIMENT_ROOT`` (default ``./experiments``).
"""
import argparse
import pdb
import sys
import traceback

from bcosification_tpu_torch.experiments.utils.config_utils import (
    get_configs_and_model_factory,
)
from bcosification_tpu_torch.training.trainer import run_training


def get_parser():
    parser = argparse.ArgumentParser(description="Start training.")
    parser.add_argument("--dataset", required=True, help="e.g. ImageNet, CIFAR10")
    parser.add_argument("--base_network", required=True, help="e.g. bcosification")
    parser.add_argument("--experiment_name", required=True, help="e.g. resnet_50")
    parser.add_argument("--distributed", action="store_true",
                        help="accepted for CLI parity; one card needs no process group")
    parser.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    parser.add_argument("--jit", action="store_true", help="accepted for CLI parity")
    parser.add_argument("--cache_dataset", choices=["onthefly", "shm", None], default=None)
    parser.add_argument("--csv_logger", action="store_true", default=True)
    parser.add_argument("--tensorboard_logger", action="store_true")
    parser.add_argument("--wandb_logger", action="store_true")
    parser.add_argument("--wandb_project", default=None)
    parser.add_argument("--wandb_id", default=None)
    parser.add_argument("--wandb_name", default=None)
    parser.add_argument(
        "--base_directory", default=None,
        help="root for experiment save dirs; unset -> BCOS_EXPERIMENT_ROOT env / settings "
        "default",
    )
    parser.add_argument("--refresh_rate", type=int, default=None,
                        help="progress print refresh rate")
    parser.add_argument("--explanation_logging", action="store_true")
    parser.add_argument("--explanation_logging_every_n_epochs", type=int, default=1)
    parser.add_argument("--fast_dev_run", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--track_grad_norm", action="store_true")
    parser.add_argument("--fsdp", action="store_true", help="not ported yet (slice 8)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor-parallel degree; not ported yet (slice 8)")
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="pipeline stages; not ported yet (slice 8)")
    parser.add_argument("--log_every_n_steps", type=int, default=50,
                        help="per-step logging cadence")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of train steps 3-8 here")
    parser.add_argument(
        "--force-no-resume", dest="resume", default=True, action="store_false",
        help="do NOT auto-resume from the last checkpoint (note the inverted dest)",
    )
    return parser


def _args_validation(args):
    configs, _ = get_configs_and_model_factory(args.dataset, args.base_network)
    if args.experiment_name not in configs:
        raise ValueError(
            f"Unknown experiment '{args.experiment_name}'. "
            f"Available: {sorted(configs)[:30]}"
        )


def main(argv=None):
    args = get_parser().parse_args(argv)
    _args_validation(args)
    if args.debug:
        try:
            run_training(args)
        except Exception:
            traceback.print_exc()
            pdb.post_mortem()
            sys.exit(1)
    else:
        run_training(args)


if __name__ == "__main__":
    main()
