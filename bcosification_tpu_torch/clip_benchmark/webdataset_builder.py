#!/usr/bin/env python
"""Convert a classification dataset into clip-benchmark webdataset shards.

Parity target: `CLIP_benchmark/clip_benchmark/
webdataset_builder.py`: writes <output>/<split>/{i}.tar shards of
(jpg, cls) pairs plus classnames.txt, zeroshot_classification_templates.txt
and nshards.txt — the layout `datasets/builder.py` reads back. Used to build
local wds mirrors for hosts without network access.
"""
from __future__ import annotations

import argparse
import io
import tarfile
from pathlib import Path


def build_webdataset(
    dataset,
    output: str,
    split: str = "test",
    max_count: int = 10_000,
    classnames=None,
    templates=None,
):
    """dataset: indexable of (image [H,W,3] float/uint8 or PIL, int label)."""
    import numpy as np
    from PIL import Image

    out = Path(output)
    (out / split).mkdir(parents=True, exist_ok=True)
    classnames = classnames or getattr(dataset, "classes", None)
    templates = templates or getattr(dataset, "templates", ["a photo of a {}."])
    if classnames:
        (out / "classnames.txt").write_text("\n".join(classnames) + "\n")
    (out / "zeroshot_classification_templates.txt").write_text(
        "\n".join(templates) + "\n"
    )

    shard_idx = 0
    count_in_shard = 0
    tf = tarfile.open(out / split / f"{shard_idx}.tar", "w")
    for i in range(len(dataset)):
        img, label = dataset[i]
        if not isinstance(img, Image.Image):
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            img = Image.fromarray(arr[..., :3])
        key = f"{i:08d}"
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=95)
        data = buf.getvalue()
        info = tarfile.TarInfo(f"{key}.jpg")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
        cls = str(int(label)).encode()
        info = tarfile.TarInfo(f"{key}.cls")
        info.size = len(cls)
        tf.addfile(info, io.BytesIO(cls))
        count_in_shard += 1
        if count_in_shard >= max_count:
            tf.close()
            shard_idx += 1
            count_in_shard = 0
            tf = tarfile.open(out / split / f"{shard_idx}.tar", "w")
    tf.close()
    n_shards = shard_idx + (1 if count_in_shard or shard_idx == 0 else 0)
    (out / split / "nshards.txt").write_text(str(n_shards) + "\n")
    return n_shards


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, help="dummy | cifar10 | imagenet1k")
    parser.add_argument("--split", default="test")
    parser.add_argument("--output", required=True)
    parser.add_argument("--max_count", type=int, default=10_000)
    args = parser.parse_args()

    from bcosification_tpu_torch.clip_benchmark.datasets.builder import build_dataset

    ds = build_dataset(args.dataset, transform=None, split=args.split)
    n = build_webdataset(ds, args.output, args.split, args.max_count)
    print(f"wrote {n} shard(s) to {args.output}/{args.split}")


if __name__ == "__main__":
    main()
