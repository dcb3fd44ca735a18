"""The evaluate command of the port, with the JAX package's ``evaluate.py``
flags: top-1 / top-5 over the test loader of an experiment.

    python -m bcosification_tpu_torch.evaluate --experiment_name resnet_50 \\
        --reload last|best|best_any|epoch_N|fresh [--ema] [--weights F] \\
        [--batch_size B] [--no-cuda] [--base_directory D]

``--reload fresh`` evaluates the model as converted (conversion-time init);
``--weights F`` loads an npz of JAX variables ("params/...", the JAX
package's export) into it. It runs on the GPU; ``--no-cuda`` runs it on
the CPU.
"""
import argparse

import torch

from bcosification_tpu_torch import settings
from bcosification_tpu_torch.bcosify.from_jax import load_jax_npz
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment


def get_parser():
    parser = argparse.ArgumentParser(description="Evaluate a model.")
    parser.add_argument("--dataset", default="ImageNet")
    parser.add_argument("--base_network", default="bcosification")
    parser.add_argument("--experiment_name", required=True)
    parser.add_argument(
        "--reload", default="last",
        help="last | best | best_any | epoch_<N> | fresh (conversion-time init)",
    )
    parser.add_argument("--ema", action="store_true", help="use EMA weights")
    parser.add_argument("--weights", default=None, help="explicit .npz weights file")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--no-cuda", "--no_cuda", dest="no_cuda", action="store_true",
                        help="run on the CPU")
    parser.add_argument("--base_directory", default=None,
                        help="root for experiment save dirs")
    return parser


def load_model_and_config(args, device=None):
    """(experiment, model in eval mode on ``device``)."""
    if getattr(args, "base_directory", None):
        settings.EXPERIMENT_ROOT = args.base_directory
    experiment = Experiment(args.dataset, args.base_network, args.experiment_name)
    if args.weights:
        model = experiment.get_model(device=device)
        load_jax_npz(model, args.weights)
    elif args.reload == "fresh":
        model = experiment.get_model(device=device)
    else:
        model = experiment.load_trained_model(args.reload, ema=args.ema, device=device)
    return experiment, model


@torch.no_grad()
def evaluate(model, loader, device):
    """(top-1, top-5) accuracy of ``model`` over ``loader``'s {"image",
    "label"} batches (dense labels are taken by their argmax), and the
    counts (correct1, correct5, n)."""
    n = c1 = c5 = 0
    for batch in loader:
        out = model(torch.as_tensor(batch["image"]).to(device), train=False)
        label = torch.as_tensor(batch["label"]).to(device)
        label = label if label.ndim == 1 else label.argmax(-1)
        top5 = out.topk(min(5, out.shape[-1]), dim=-1).indices
        c1 += int((out.argmax(-1) == label).sum())
        c5 += int((top5 == label[:, None]).any(-1).sum())
        n += int(label.shape[0])
        print(f"\r{n}: top1 {c1 / max(n, 1):.4%} top5 {c5 / max(n, 1):.4%}", end="")
    print()
    return c1 / max(n, 1), c5 / max(n, 1), (c1, c5, n)


def run_evaluation(args, device=None):
    """The evaluate command on ``device`` (default the GPU, or the CPU with
    ``--no-cuda``). Returns (top-1, top-5, (correct1, correct5, n))."""
    if device is None and getattr(args, "no_cuda", False):
        device = "cpu"
    dev = resolve_device(device)
    experiment, model = load_model_and_config(args, device=dev)
    datamodule = experiment.get_datamodule()
    if args.batch_size:
        datamodule.batch_size = args.batch_size
    datamodule.setup("test")
    top1, top5, counts = evaluate(model, datamodule.test_dataloader(), dev)
    print(f"Final: top-1 {top1:.4%}, top-5 {top5:.4%}")
    return top1, top5, counts


def main(argv=None):
    return run_evaluation(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
