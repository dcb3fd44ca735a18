"""Data modules with a name registry (the port's copy of
``bcosification_tpu/data/datamodules.py``).

``ClassificationDataModule`` is the registry base, with the Mixup / Cutmix
/ SplitAndGrid collate and the repeated-augmentation sampler;
``ImageNetDataModule`` reads an ImageFolder tree (``IMAGENET_PATH`` with
``train/`` and ``val/``); CIFAR10/100, FashionMNIST and STL10 have numpy
readers. Batches are dicts of numpy arrays, "image" [N, H, W, C] float32
and "label"; the trainer moves them to the card.

``VOCDataModule`` reads the VOC2007 layout (``VOC_PATH``: ImageSets/Main,
JPEGImages, Annotations): multilabel targets from the XML annotations and,
with ``also_annotation``, the boxes rescaled to ``bbox_size``. CC3M's module
is in ``data/cc3m.py``. Not ported yet: the C++ loader (``native_loader=True``
raises: it needs libjpeg, which the H100 machine lacks).

``split_by_process`` (a process group, ``parallel/dp.py``): each rank's
train sampler draws only its 1/W of the train set, rank-strided (the
repeated-augmentation sampler with ``repetitions=1``, every sample once per
epoch, unless ``ra_repetitions`` is set), and the loader drops the last
partial batch, so every rank runs the same number of steps of the same
batch size; validation stays whole on every rank.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from bcosification_tpu_torch import settings
from bcosification_tpu_torch.data import transforms as T
from bcosification_tpu_torch.data.categories import (
    CIFAR10_CATEGORIES,
    CIFAR100_CATEGORIES,
    FASHION_MNIST_CATEGORIES,
    IMAGENET_CATEGORIES,
    STL10_CATEGORIES,
    VOC_CATEGORIES,
)
from bcosification_tpu_torch.data.loader import DataLoader, default_collate
from bcosification_tpu_torch.data.sampler import RASampler

__all__ = [
    "ClassificationDataModule",
    "ImageNetDataModule",
    "CIFAR10DataModule",
    "VOCDataModule",
    "ImageFolder",
]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".jfif")
NATIVE_LOADER_SLICE = ("port slice 6e (the native JPEG loader, ROADMAP A5), which waits: "
                       "the H100 machine has neither libjpeg's headers nor its library")


class ImageFolder:
    """torchvision-style ImageFolder: root/class_x/xxx.jpg, classes in
    sorted order, files sorted by name."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = Path(root)
        self.transform = transform
        classes = sorted(d.name for d in os.scandir(self.root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.classes = classes
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            for f in sorted(os.scandir(self.root / c), key=lambda e: e.name):
                if f.name.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((f.path, self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, target = self.samples[i]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.transform is not None:
                img = self.transform(img)
        return np.asarray(img, np.float32), np.int32(target)


class ClassificationDataModule:
    """Registry base: a subclass ``<Name>DataModule`` registers as <Name>."""

    NUM_CLASSES: Optional[int] = None
    NUM_TRAIN_EXAMPLES: Optional[int] = None
    NUM_EVAL_EXAMPLES: Optional[int] = None
    CATEGORIES: Optional[List[str]] = None

    __registry: Dict[str, type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.__name__.startswith("_"):  # a private base, not a dataset
            return
        assert cls.NUM_CLASSES is not None
        name = cls.__name__
        if not name.endswith("DataModule"):
            raise ValueError(f"'{name}' does not end with 'DataModule'")
        name = name[: -len("DataModule")]
        if name in ClassificationDataModule.__registry:
            raise ValueError(f"Data module {name} already registered")
        ClassificationDataModule.__registry[name] = cls

    @classmethod
    def registry(cls) -> Dict[str, type]:
        return dict(cls.__registry)

    def __init__(self, config: Dict[str, Any]):
        if config.get("native_loader", False):
            raise NotImplementedError(
                f"data.native_loader: the C++ loader is not ported yet; it comes in "
                f"{NATIVE_LOADER_SLICE}")
        self.config = config
        self.batch_size = config["batch_size"]
        self.num_workers = config.get("num_workers", 8)
        self.train_dataset = None
        self.eval_dataset = None
        self.train_collate_fn = self.get_train_collate_fn(
            config.get("mixup_alpha", 0.0),
            config.get("cutmix_alpha", 0.0),
            config.get("p_gridified", 0.0),
        )

    def setup(self, stage: Optional[str] = None):
        raise NotImplementedError

    def train_dataloader(self, seed: int = 0) -> DataLoader:
        sampler = self.get_train_sampler(seed)
        return DataLoader(
            self.train_dataset,
            self.batch_size,
            shuffle=sampler is None,
            sampler=sampler,
            num_workers=self.num_workers,
            collate_fn=self.train_collate_fn,
            drop_last=True,
            seed=seed,
        )

    def val_dataloader(self) -> DataLoader:
        return DataLoader(
            self.eval_dataset,
            self.batch_size,
            num_workers=self.num_workers,
            collate_fn=self._eval_collate,
        )

    test_dataloader = val_dataloader

    @staticmethod
    def _eval_collate(batch):
        images, targets = default_collate(batch)
        return {"image": images, "label": targets}

    @classmethod
    def get_train_collate_fn(cls, mixup_alpha=0.0, cutmix_alpha=0.0, p_gridified=0.0):
        """The train collate: stacking, then SplitAndGrid or one of Mixup and
        Cutmix (chosen per batch with numpy's global rng, as the JAX package
        does)."""
        assert not (p_gridified and mixup_alpha), "For now, do not use both."
        collate_fn = None
        if p_gridified:
            gridify = T.SplitAndGrid(p_gridified, num_classes=cls.NUM_CLASSES)

            def collate_fn(batch):
                images, targets = default_collate(batch)
                images, targets = gridify(images, targets)
                return {"image": images, "label": targets}

        choices = []
        if mixup_alpha > 0.0:
            choices.append(T.RandomMixup(cls.NUM_CLASSES, p=1.0, alpha=mixup_alpha))
        if cutmix_alpha > 0.0:
            choices.append(T.RandomCutmix(cls.NUM_CLASSES, p=1.0, alpha=cutmix_alpha))
        if choices:
            def collate_fn(batch):  # noqa: F811
                images, targets = default_collate(batch)
                t = choices[np.random.randint(len(choices))]
                images, targets = t(images, targets)
                return {"image": images, "label": targets}

        if collate_fn is None:
            def collate_fn(batch):
                images, targets = default_collate(batch)
                return {"image": images, "label": targets}

        return collate_fn

    def get_train_sampler(self, seed: int = 0):
        """RASampler with the config's ``ra_repetitions``, else None (the
        loader shuffles). ``split_by_process`` under a group of W ranks: the
        sampler over W replicas at this rank, with ``repetitions=1`` and
        every sample selected unless ``ra_repetitions`` is set (which keeps
        the reference's truncation to a multiple of 256)."""
        rank, world = 0, 1
        if self.config.get("split_by_process", False):
            from bcosification_tpu_torch.parallel import dp

            rank, world = dp.rank(), dp.world_size()
        ra_reps = self.config.get("ra_repetitions", None)
        if ra_reps is None and world == 1:
            return None
        return RASampler(self.train_dataset, num_replicas=world, rank=rank, shuffle=True,
                         seed=seed, repetitions=ra_reps or 1, select_all=ra_reps is None)


class ImageNetDataModule(ClassificationDataModule):
    NUM_CLASSES = 1000
    NUM_TRAIN_EXAMPLES = 1_281_167
    NUM_EVAL_EXAMPLES = 50_000
    CATEGORIES = IMAGENET_CATEGORIES

    def setup(self, stage: Optional[str] = None):
        root = self.config.get("data_root") or settings.IMAGENET_PATH
        assert root, "Set IMAGENET_PATH"
        cache = self.config.get("cache_dataset")
        if stage in (None, "fit", "train"):
            self.train_dataset = ImageFolder(
                os.path.join(root, "train"), self.config["train_transform"]
            )
            if cache in ("onthefly", "shm"):
                from bcosification_tpu_torch.data.caching import CachedImageFolder

                self.train_dataset = CachedImageFolder(
                    self.train_dataset, use_shm=(cache == "shm")
                )
        self.eval_dataset = ImageFolder(
            os.path.join(root, "val"), self.config["test_transform"]
        )


class _ArrayDataset:
    """Images [N, H, W, C] uint8 and int32 targets, with a transform."""

    def __init__(self, data, targets, transform=None):
        self.data, self.targets, self.transform = data, targets, transform

    def __len__(self):
        return len(self.data)

    def _image(self, i):
        return self.data[i]

    def __getitem__(self, i):
        img = self._image(i)
        if self.transform is not None:
            img = self.transform(img)
        return np.asarray(img, np.float32), self.targets[i]


def _cifar10(root: str, train: bool, transform=None) -> _ArrayDataset:
    """The CIFAR-10 python batches."""
    base = Path(root) / "cifar-10-batches-py"
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for f in files:
        with open(base / f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return _ArrayDataset(data, np.asarray(ys, np.int32), transform)


def _cifar100(root: str, train: bool, transform=None) -> _ArrayDataset:
    """The CIFAR-100 python pickle (fine labels)."""
    with open(Path(root) / "cifar-100-python" / ("train" if train else "test"), "rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    data = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return _ArrayDataset(data, np.asarray(d[b"fine_labels"], np.int32), transform)


class _FashionMNISTDataset(_ArrayDataset):
    """The FashionMNIST idx-ubyte files (gz or raw); greyscale replicated to
    3 channels."""

    def __init__(self, root: str, train: bool, transform=None):
        import gzip

        base = Path(root) / "FashionMNIST" / "raw"
        prefix = "train" if train else "t10k"

        def read(name):
            gz = base / f"{name}.gz"
            if gz.exists():
                with gzip.open(gz, "rb") as fh:
                    return fh.read()
            return (base / name).read_bytes()

        imgs = read(f"{prefix}-images-idx3-ubyte")
        lbls = read(f"{prefix}-labels-idx1-ubyte")
        n = int.from_bytes(imgs[4:8], "big")
        super().__init__(np.frombuffer(imgs, np.uint8, offset=16).reshape(n, 28, 28),
                         np.frombuffer(lbls, np.uint8, offset=8).astype(np.int32), transform)

    def _image(self, i):
        return np.repeat(self.data[i][..., None], 3, axis=-1)


def _stl10(root: str, train: bool, transform=None) -> _ArrayDataset:
    """The STL-10 binaries (uint8 [N, 3, 96, 96], column-major planes;
    labels 1..10)."""
    base = Path(root) / "stl10_binary"
    split = "train" if train else "test"
    x = np.fromfile(base / f"{split}_X.bin", np.uint8)
    data = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
    y = np.fromfile(base / f"{split}_y.bin", np.uint8)
    return _ArrayDataset(data, y.astype(np.int32) - 1, transform)


class _ArrayDataModule(ClassificationDataModule):
    """A module over DATA_ROOT read by ``READER(root, train, transform)``."""

    READER: Callable = None

    def setup(self, stage: Optional[str] = None):
        root = self.config.get("data_root") or settings.DATA_ROOT
        assert root, "Set DATA_ROOT"
        read = type(self).READER
        if stage in (None, "fit", "train"):
            self.train_dataset = read(root, True, self.config["train_transform"])
        self.eval_dataset = read(root, False, self.config["test_transform"])


class CIFAR10DataModule(_ArrayDataModule):
    NUM_CLASSES = 10
    NUM_TRAIN_EXAMPLES = 50_000
    NUM_EVAL_EXAMPLES = 10_000
    CATEGORIES = CIFAR10_CATEGORIES
    READER = staticmethod(_cifar10)


class CIFAR100DataModule(_ArrayDataModule):
    NUM_CLASSES = 100
    NUM_TRAIN_EXAMPLES = 50_000
    NUM_EVAL_EXAMPLES = 10_000
    CATEGORIES = CIFAR100_CATEGORIES
    READER = staticmethod(_cifar100)


class FashionMNISTDataModule(_ArrayDataModule):
    NUM_CLASSES = 10
    NUM_TRAIN_EXAMPLES = 60_000
    NUM_EVAL_EXAMPLES = 10_000
    CATEGORIES = FASHION_MNIST_CATEGORIES
    READER = _FashionMNISTDataset


class STL10DataModule(_ArrayDataModule):
    NUM_CLASSES = 10
    NUM_TRAIN_EXAMPLES = 5_000
    NUM_EVAL_EXAMPLES = 8_000
    CATEGORIES = STL10_CATEGORIES
    READER = staticmethod(_stl10)


class _VOCDataset:
    """VOC multilabel dataset with XML annotation parse
    (datamodules.py:283-460).

    With ``also_annotation=True`` each item is (image, target, bbs) where
    bbs = [[class_idx, xmin, ymin, xmax, ymax], ...] with box coordinates
    rescaled to the ``bbox_size`` output resolution and clamped — exactly
    the reference's box path (ref datamodules.py:404-425, which hardcodes
    224), used by box-based localisation evaluation.
    """

    def __init__(
        self,
        root: str,
        image_set: str,
        transform=None,
        also_annotation: bool = False,
        bbox_size: int = 224,
    ):
        from xml.etree.ElementTree import parse as ET_parse

        self.root = Path(root)
        self.transform = transform
        self.also_annotation = also_annotation
        self.bbox_size = bbox_size
        split_file = (
            self.root / "ImageSets" / "Main" / f"{image_set}.txt"
        )
        with open(split_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.images = [self.root / "JPEGImages" / f"{i}.jpg" for i in ids]
        self.annotations = [self.root / "Annotations" / f"{i}.xml" for i in ids]
        self._parse = ET_parse
        self.cat_to_idx = {c: i for i, c in enumerate(VOC_CATEGORIES)}

    def __len__(self):
        return len(self.images)

    def _parse_objects(self, ann_path):
        """(target multilabel vector, [(name, bndbox-element)], (width, height))."""
        root = self._parse(ann_path).getroot()
        label = np.zeros(len(VOC_CATEGORIES), np.float32)
        objects = []
        for obj in root.iter("object"):
            name = obj.find("name").text
            if name in self.cat_to_idx:
                label[self.cat_to_idx[name]] = 1.0
                objects.append((name, obj.find("bndbox")))
        size = root.find("size")
        width = int(size.find("width").text) if size is not None else None
        height = int(size.find("height").text) if size is not None else None
        return label, objects, (width, height)

    def _target(self, ann_path) -> np.ndarray:
        return self._parse_objects(ann_path)[0]

    def _bboxes(self, objects, width, height):
        """[[class_idx, xmin, ymin, xmax, ymax]] rescaled to bbox_size
        (ref datamodules.py:404-425: int() truncation, clamp to [0, S-1])."""
        S = self.bbox_size
        wscale, hscale = S / width, S / height
        bbs = []
        for name, box in objects:
            xmin, xmax = int(box.find("xmin").text), int(box.find("xmax").text)
            ymin, ymax = int(box.find("ymin").text), int(box.find("ymax").text)
            bbs.append([
                self.cat_to_idx[name],
                int(min(max(xmin * wscale, 0), S - 1)),
                int(min(max(ymin * hscale, 0), S - 1)),
                int(min(max(xmax * wscale, 0), S - 1)),
                int(min(max(ymax * hscale, 0), S - 1)),
            ])
        return bbs

    def __getitem__(self, i):
        from PIL import Image

        with Image.open(self.images[i]) as img:
            img = img.convert("RGB")
            size = img.size  # (width, height) before transform
            if self.transform is not None:
                img = self.transform(img)
        image = np.asarray(img, np.float32)
        label, objects, (width, height) = self._parse_objects(self.annotations[i])
        if self.also_annotation:
            width, height = width or size[0], height or size[1]
            return image, label, self._bboxes(objects, width, height)
        return image, label


class VOCDataModule(ClassificationDataModule):
    NUM_CLASSES = 20
    CATEGORIES = VOC_CATEGORIES

    def setup(self, stage: Optional[str] = None):
        root = self.config.get("data_root") or settings.VOC_PATH
        assert root, "Set VOC_PATH"
        also_annotation = bool(self.config.get("also_annotation", False))
        if stage in (None, "fit", "train"):
            self.train_dataset = _VOCDataset(
                root, "trainval", self.config["train_transform"]
            )
        self.eval_dataset = _VOCDataset(
            root, "val", self.config["test_transform"],
            also_annotation=also_annotation,
        )
