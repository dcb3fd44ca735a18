"""Export a trained experiment as a serving program (counterpart of the
repository's ``scripts/export_serving.py``).

    python -m bcosification_tpu_torch.scripts.export_serving --dataset ImageNet \\
        --base_network bcosification --experiment_name resnet_50 --reload last \\
        --out rn50.pt2 [--explain] [--ema] [--input_size 224] [--channels 6] \\
        [--base_directory D]

The program (``torch.export``, fp32 input with a symbolic batch) embeds the
weights; load it with ``bcosification_tpu_torch.serving.load_serialized(blob)
.call(x)``, no model code needed. ``--explain`` exports the fused forward +
explanation (logits, selected class, dynamic-linear W(x)) instead of the
plain forward. The model loads, and the program is traced, on the GPU.
"""
import argparse
import os

__all__ = ["main"]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="ImageNet")
    p.add_argument("--base_network", default="bcosification")
    p.add_argument("--experiment_name", required=True)
    p.add_argument("--base_directory", default=None)
    p.add_argument("--reload", default="last")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--explain", action="store_true")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--channels", type=int, default=6)
    p.add_argument("--out", required=True)
    return p


def main(argv=None, device=None) -> str:
    """Run the command; the model loads and is exported on ``device``
    (default the GPU)."""
    args = get_parser().parse_args(argv)

    from bcosification_tpu_torch import serving, settings
    from bcosification_tpu_torch.device import resolve_device
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    if args.base_directory:
        os.environ["BCOS_EXPERIMENT_ROOT"] = args.base_directory
        settings.EXPERIMENT_ROOT = args.base_directory

    dev = resolve_device(device)
    exp = Experiment(args.dataset, args.base_network, args.experiment_name)
    model = exp.load_trained_model(reload=args.reload, ema=args.ema, device=dev)
    export = serving.export_explain if args.explain else serving.export_forward
    blob = export(model, input_size=args.input_size, channels=args.channels, device=dev)
    with open(args.out, "wb") as f:
        f.write(bytes(blob))
    print(f"wrote {args.out}: {len(blob)/1e6:.1f} MB "
          f"({'fwd+explain' if args.explain else 'forward'}, "
          f"input {args.input_size}x{args.input_size}x{args.channels})")
    return args.out


if __name__ == "__main__":
    main()
