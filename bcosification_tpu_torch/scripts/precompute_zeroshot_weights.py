"""Precompute the ImageNet zero-shot classifier matrix from a CLIP text tower
(counterpart of the repository's ``scripts/precompute_zeroshot_weights.py``).

    python -m bcosification_tpu_torch.scripts.precompute_zeroshot_weights \\
        --out imagenet_rn50_zs.npy [--clip-weights RN50.pt] [--batch-classes 32]

The output is a float32 .npy [D, 1000] (the 1000 ImageNet classes, each the
prompt ensemble of the 80 OpenAI templates), as the per-epoch ImageNet
zero-shot evaluation reads it from ``IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH``
(``training.zeroshot.load_zeroshot_weights``). The text tower runs on the GPU.

The weights are local files only: ``--clip-weights``, ``$CLIP_WEIGHTS_PATH``
or ``$CLIP_WEIGHTS_DIR/RN50.{pt,pth,npz}``. Nothing is downloaded, and a
random-init text tower is refused: its classifier would be noise.
"""
import argparse
import importlib
import os

__all__ = ["main"]


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="output .npy path")
    ap.add_argument("--clip-weights", default=None,
                    help="OpenAI CLIP RN50 checkpoint (defaults to $CLIP_WEIGHTS_PATH)")
    ap.add_argument("--batch-classes", type=int, default=32)
    return ap


def main(argv=None, device=None) -> str:
    """Run the command; the text tower runs on ``device`` (default the GPU)."""
    ap = get_parser()
    args = ap.parse_args(argv)

    from bcosification_tpu_torch.data import imagenet
    from bcosification_tpu_torch.training import zeroshot as zs_lib

    # the module: the package's __init__ exports the function ``load`` over it
    clip_load = importlib.import_module("bcosification_tpu_torch.clip.load")
    if args.clip_weights:
        os.environ["CLIP_WEIGHTS_PATH"] = args.clip_weights
    try:
        found = clip_load.load_state_dict_file("RN50") is not None
    except RuntimeError:  # BCOS_ALLOW_DOWNLOAD=1: the port has no network path
        found = False
    if not found:
        ap.error("no CLIP RN50 weights found: set --clip-weights, CLIP_WEIGHTS_PATH or "
                 "CLIP_WEIGHTS_DIR (local files only; nothing is downloaded)")
    _, text_model, _, _ = clip_load.load("RN50", pretrained=True, device=device)
    w = zs_lib.zeroshot_classifier(text_model, imagenet.imagenet_classes,
                                   imagenet.imagenet_templates,
                                   batch_classes=args.batch_classes)
    zs_lib.save_zeroshot_weights(args.out, w)
    print(f"saved [{w.shape[0]}, {w.shape[1]}] zeroshot weights -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
