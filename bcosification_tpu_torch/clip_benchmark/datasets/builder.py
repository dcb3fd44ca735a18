"""Dataset builder for the CLIP benchmark CLI (the port's copy of the JAX
package's ``clip_benchmark/datasets/builder.py``; numpy and PIL only).

Re-implements the upstream LAION `clip_benchmark.datasets.builder` that the
vendored fork imports but does not ship (`CLIP_benchmark/
clip_benchmark/cli.py:13-16` — see SURVEY.md §2.12). Supports:

- ``dummy``: a synthetic classification set (used by the upstream smoke tests,
  `CLIP_benchmark/tests/test_clip_benchmark.py`).
- ``wds/<name>``: webdataset shards in the clip-benchmark layout —
  <root>/<split>/{i}.tar (+ classnames.txt, zeroshot_classification_templates
  .txt, nshards.txt) — read with the framework's dependency-free tar pipeline.
  Remote HF URLs are NOT fetched (no network path); point --dataset_root
  at a local mirror.
- plain names (cifar10, imagenet1k, voc2007) via the port's datamodules
  when the respective data paths are configured.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

__all__ = ["build_dataset", "get_dataset_collate_fn", "get_dataset_default_task"]

RETRIEVAL_DATASETS = {"flickr30k", "flickr8k", "mscoco_captions", "crossmodal3600"}
CAPTION_DATASETS = {"sugar_crepe", "winoground"}


def get_dataset_default_task(dataset_name: str) -> str:
    name = dataset_name.split("/")[-1]
    if name in RETRIEVAL_DATASETS or name == "dummy_retrieval":
        return "zeroshot_retrieval"
    if name in CAPTION_DATASETS:
        return "image_caption_selection"
    return "zeroshot_classification"


class DummyDataset:
    """Synthetic 3-class dataset of random images."""

    def __init__(self, transform=None, n: int = 32, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.random((n, 64, 64, 3)).astype(np.float32)
        self.targets = rng.integers(0, 3, n).astype(np.int32)
        self.transform = transform
        self.classes = ["cat", "dog", "bird"]
        self.templates = ["a photo of a {}."]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return np.asarray(img, np.float32), self.targets[i]


class DummyRetrievalDataset(DummyDataset):
    """Synthetic image+captions set for retrieval/captioning smoke runs
    (upstream's `dataset="dummy"` analogue for the caption tasks)."""

    def __getitem__(self, i):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        cls = self.classes[self.targets[i]]
        caps = [f"a photo of a {cls}.", f"the {cls}."]
        return np.asarray(img, np.float32), caps


class WdsClassificationDataset:
    """clip-benchmark wds/* layout over local shards (loads into an indexable
    dataset; eval sets are small)."""

    def __init__(self, root: str, split: str = "test", transform=None):
        from bcosification_tpu_torch.data.cc3m import iter_tar_samples

        self.transform = transform
        root = Path(root)
        self.classes = self._read_lines(root / "classnames.txt")
        self.templates = self._read_lines(
            root / "zeroshot_classification_templates.txt"
        )
        split_dir = root / split
        shards = sorted(str(p) for p in split_dir.glob("*.tar"))
        if not shards:
            raise FileNotFoundError(f"no shards under {split_dir}")
        self.samples: List[dict] = []
        for shard in shards:
            for s in iter_tar_samples(shard):
                self.samples.append(s)

    @staticmethod
    def _read_lines(path):
        if not path.exists():
            return None
        with open(path) as f:
            return [line.rstrip("\n") for line in f if line.strip()]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        import io

        from PIL import Image

        s = self.samples[i]
        img_bytes = next(
            (s[e] for e in ("jpg", "jpeg", "png", "webp") if e in s), None
        )
        with Image.open(io.BytesIO(img_bytes)) as img:
            img = img.convert("RGB")
            if self.transform is not None:
                img = self.transform(img)
        if "cls" in s:
            target = int(s["cls"].decode())
        elif "npy" in s:
            target = np.load(io.BytesIO(s["npy"]))
        else:
            target = -1
        return np.asarray(img, np.float32), target


class WdsRetrievalDataset(WdsClassificationDataset):
    """Retrieval layout: images + one-or-more txt captions per sample."""

    def __getitem__(self, i):
        import io

        from PIL import Image

        s = self.samples[i]
        img_bytes = next((s[e] for e in ("jpg", "jpeg", "png", "webp") if e in s), None)
        with Image.open(io.BytesIO(img_bytes)) as img:
            img = img.convert("RGB")
            if self.transform is not None:
                img = self.transform(img)
        caps = s.get("txt", b"").decode("utf-8", errors="replace").split("\n")
        caps = [c for c in caps if c.strip()]
        return np.asarray(img, np.float32), caps


def build_dataset(
    dataset_name: str,
    root: str = "root",
    transform: Optional[Callable] = None,
    split: str = "test",
    download: bool = False,
    annotation_file: Optional[str] = None,
    language: str = "en",
    task: str = "zeroshot_classification",
    custom_classname_file: Optional[str] = None,
    custom_template_file: Optional[str] = None,
    wds_cache_dir: Optional[str] = None,
    **kwargs,
):
    if dataset_name == "dummy":
        return DummyDataset(transform=transform)
    if dataset_name == "dummy_retrieval":
        return DummyRetrievalDataset(transform=transform)
    if dataset_name.startswith("wds/"):
        name = dataset_name[len("wds/") :]
        root = root.format(dataset=name.replace("/", "-"), dataset_cleaned=name.replace("/", "-")) if "{" in root else root
        if task in ("zeroshot_retrieval", "captioning", "image_caption_selection"):
            # caption-bearing samples (image, [captions]) — the reference's
            # builder routes every caption-consuming task through the
            # retrieval-style wds reader (ref builder.py wds branch); the
            # classification reader's int labels would crash ptb_tokenize
            return WdsRetrievalDataset(root, split=split, transform=transform)
        return WdsClassificationDataset(root, split=split, transform=transform)

    # framework datamodules
    from bcosification_tpu_torch.data.datamodules import ClassificationDataModule
    from bcosification_tpu_torch.data.imagenet import imagenet_classes, imagenet_templates

    registry = {k.lower(): v for k, v in ClassificationDataModule.registry().items()}
    key = {"imagenet1k": "imagenet", "cifar10": "cifar10", "voc2007": "voc"}.get(
        dataset_name.lower(), dataset_name.lower()
    )
    if key in registry:
        dm = registry[key](
            {
                "batch_size": 64,
                "num_workers": 8,
                "train_transform": transform,
                "test_transform": transform,
                "data_root": None if root in ("root", "") else root,
            }
        )
        dm.setup("fit" if split == "train" else "test")
        ds = dm.train_dataset if split == "train" else dm.eval_dataset
        ds.classes = imagenet_classes if key == "imagenet" else dm.CATEGORIES
        ds.templates = imagenet_templates
        return ds
    raise ValueError(f"Unsupported dataset {dataset_name!r}")


def image_captions_collate(samples):
    """Collate (image, captions) pairs: stack images, keep captions as a list
    of per-image caption lists (default_collate would coerce them into string
    ndarrays, which the retrieval/captioning metrics then mis-wrap as a
    single caption — upstream ships the same dedicated collate)."""
    images = np.stack([np.asarray(img, np.float32) for img, _ in samples])
    captions = [list(caps) if isinstance(caps, (list, tuple)) else [caps] for _, caps in samples]
    return images, captions


def get_dataset_collate_fn(dataset_name: str):
    from bcosification_tpu_torch.data.loader import default_collate

    name = dataset_name.split("/")[-1]
    if name in RETRIEVAL_DATASETS or name in CAPTION_DATASETS or name == "dummy_retrieval":
        return image_captions_collate
    return default_collate
