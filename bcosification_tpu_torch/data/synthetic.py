"""Synthetic ImageNet-layout and CC3M-layout trees, made from a seed, for
driving the train and evaluate commands where no copy of the data is at
hand:

    python -m bcosification_tpu_torch.data.synthetic --out D [--classes 10]
        [--train 704] [--val 128] [--size 500x375] [--seed 0]
    python -m bcosification_tpu_torch.data.synthetic --cc3m --out D
        [--shards 4] [--pairs 70] [--size 500x375] [--seed 0]

The first writes ``D/train/<wnid>/*.JPEG`` and ``D/val/<wnid>/*.JPEG`` with
real wnids of the ImageNet class index (the first ``classes`` of it),
spread round-robin over the classes. The second writes CC3M's tar shards:
``D/training/{00000..00331}.tar``, of which the first ``shards`` are
distinct and the others symbolic links to them, and
``D/validation/{00000..00001}.tar``; each distinct shard holds ``pairs``
(JPEG, caption) pairs. Each image is a smooth colour field (a random 8 x 6
grid resized bicubically) plus mild noise, saved at quality 90, so that
decoding it costs about what a photo of its size costs rather than what
pure noise costs. ImageNet's typical image is 500 x 375.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from bcosification_tpu_torch.data.categories import imagenet_class_index

__all__ = ["write_image", "write_imagenet_tree", "write_cc3m_tree"]

CC3M_TRAIN_SHARDS, CC3M_VAL_SHARDS = 332, 2


def write_image(path, size: Tuple[int, int], seed) -> None:
    """One smooth JPEG of ``size`` (width, height) from ``seed``, written to
    ``path`` (a file name or a binary file)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h = size
    coarse = Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    field = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.float32)
    field += rng.normal(0.0, 6.0, field.shape).astype(np.float32)
    img = Image.fromarray(np.clip(field, 0, 255).astype(np.uint8))
    img.save(path, "JPEG", quality=90)


def _write_shard(path, size, seed, n_pairs: int) -> None:
    """A tar of ``n_pairs`` (<key>.jpg, <key>.txt) pairs."""
    import io
    import tarfile

    with tarfile.open(path, "w") as tf:
        for i in range(n_pairs):
            buf = io.BytesIO()
            write_image(buf, size, (*seed, i))
            caption = f"a synthetic photo, number {i} of shard {seed[-1]}".encode()
            for ext, data in (("jpg", buf.getvalue()), ("txt", caption)):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def write_cc3m_tree(root, n_distinct: int = 4, n_pairs: int = 70,
                    size: Tuple[int, int] = (500, 375), seed: int = 0) -> None:
    """Write CC3M's 332 train and 2 val shards under ``root`` (see the
    module docstring)."""
    train, val = Path(root) / "training", Path(root) / "validation"
    train.mkdir(parents=True, exist_ok=True)
    val.mkdir(parents=True, exist_ok=True)
    jobs = [(train / f"{i:05d}.tar", size, (seed, 0, i), n_pairs) for i in range(n_distinct)]
    jobs += [(val / f"{i:05d}.tar", size, (seed, 1, i), n_pairs)
             for i in range(CC3M_VAL_SHARDS)]
    with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda job: _write_shard(*job), jobs))
    for i in range(n_distinct, CC3M_TRAIN_SHARDS):
        link = train / f"{i:05d}.tar"
        if not link.exists():
            link.symlink_to(f"{i % n_distinct:05d}.tar")


def write_imagenet_tree(root, n_classes: int = 10, n_train: int = 704, n_val: int = 128,
                        sizes: Sequence[Tuple[int, int]] = ((500, 375),), seed: int = 0,
                        workers: int = 0) -> list:
    """Write the tree under ``root``; image i of a split takes size
    ``sizes[i % len(sizes)]``. Returns the wnids, in class order."""
    index = imagenet_class_index()
    wnids = [index[str(i)][0] for i in range(n_classes)]
    jobs = []
    for split_id, (split, count) in enumerate((("train", n_train), ("val", n_val))):
        for wnid in wnids:
            (Path(root) / split / wnid).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            wnid = wnids[i % n_classes]
            path = Path(root) / split / wnid / f"{wnid}_{split}_{i:06d}.JPEG"
            jobs.append((path, sizes[i % len(sizes)], (seed, split_id, i)))
    with cf.ThreadPoolExecutor(max_workers=workers or min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda job: write_image(*job), jobs))
    return wnids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--cc3m", action="store_true", help="write CC3M's tar shards")
    parser.add_argument("--shards", type=int, default=4, help="CC3M: distinct train shards")
    parser.add_argument("--pairs", type=int, default=70, help="CC3M: pairs per shard")
    parser.add_argument("--classes", type=int, default=10)
    parser.add_argument("--train", type=int, default=704)
    parser.add_argument("--val", type=int, default=128)
    parser.add_argument("--size", default="500x375", help="WIDTHxHEIGHT")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x"))
    if args.cc3m:
        write_cc3m_tree(args.out, args.shards, args.pairs, size, args.seed)
        print(f"wrote {CC3M_TRAIN_SHARDS} train shards ({args.shards} distinct) and "
              f"{CC3M_VAL_SHARDS} val shards of {args.pairs} {size[0]}x{size[1]} JPEG + "
              f"caption pairs under {args.out}")
        return
    wnids = write_imagenet_tree(args.out, args.classes, args.train, args.val, (size,),
                                args.seed)
    print(f"wrote {args.train} train and {args.val} val JPEGs of {size[0]}x{size[1]} in "
          f"{len(wnids)} classes under {args.out}")


if __name__ == "__main__":
    main()
