"""CC3M as webdataset-style tar shards, read with the standard library (the
port's copy of ``bcosification_tpu/data/cc3m.py``).

A shard is a tar of samples whose members share a key prefix
(``00042.jpg``, ``00042.txt``). ``WdsPipeline`` streams the shards in a
seeded order through a seeded shuffle buffer, decodes the images with PIL,
applies the transform and yields batches (partial batches dropped).
``CC3MDataModule`` (registered as "CC3M") reads
``$CC3M_PATH/training/{00000..00331}.tar`` and
``validation/{00000..00001}.tar``; every shard of a pattern must exist.

Not ported yet: the C++ decode path (``native_decode=True`` raises; "auto"
takes PIL, as the JAX package does when its library is not built) and the
per-process split of the train shards (``split_shards_by_process`` raises).
"""
from __future__ import annotations

import io
import os
import re
import tarfile
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from bcosification_tpu_torch import settings
from bcosification_tpu_torch.data.datamodules import (
    NATIVE_LOADER_SLICE,
    SPLIT_BY_PROCESS_SLICE,
    ClassificationDataModule,
)

__all__ = [
    "expand_shard_pattern",
    "iter_tar_samples",
    "WdsPipeline",
    "CC3MDataModule",
]

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


def expand_shard_pattern(pattern: str) -> List[str]:
    """Expand a '{00000..00331}.tar' brace range (zero-padded to the width
    of its lower end)."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    return [pattern[: m.start()] + str(i).zfill(len(lo)) + pattern[m.end():]
            for i in range(int(lo), int(hi) + 1)]


def iter_tar_samples(shard_path: str) -> Iterator[Dict[str, object]]:
    """Stream one tar shard as dicts {"__key__": key, <ext>: bytes, ...}, one
    per run of members with the same key prefix."""
    current_key = None
    sample: Dict[str, object] = {}
    with tarfile.open(shard_path, "r|*") as tf:
        for member in tf:
            if not member.isfile() or "." not in member.name:
                continue
            key, ext = member.name.split(".", 1)
            if key != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            f = tf.extractfile(member)
            if f is not None:
                sample[ext.lower()] = f.read()
        if current_key is not None and sample:
            yield sample


def _decode_image(data: bytes):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return img.convert("RGB")


@dataclass
class WdsPipeline:
    """Iterable over batches of a set of tar shards.

    mode "image": {"image": [B, H, W, C] float32, "key": [B]};
    mode "text": {"text": tokens [B, 77] (or the strings without a
    tokenizer), "key"}; mode "pair": all three.

    With ``shuffle_buffer`` the shard order and the buffer's draws come from
    one numpy Generator seeded with (seed, epoch, pass); ``set_epoch`` sets
    the epoch. ``repeat`` loops the stream forever, each pass reshuffled.
    """

    shards: Sequence[str]
    batch_size: int
    mode: str = "pair"
    transform: Optional[Callable] = None
    tokenizer: Optional[Callable] = None
    shuffle_buffer: int = 0
    seed: int = 0
    drop_partial: bool = True
    # the JAX package's C++ decode path; "auto" takes PIL here, a truthy
    # value raises
    native_decode: object = "auto"
    repeat: bool = False

    def __post_init__(self):
        if self.native_decode != "auto" and self.native_decode:
            raise NotImplementedError(
                f"native_decode={self.native_decode!r}: the C++ decode path is not ported "
                f"yet; it comes in {NATIVE_LOADER_SLICE}")

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _samples(self) -> Iterator[Dict[str, object]]:
        rng = np.random.default_rng(
            (self.seed, getattr(self, "_epoch", 0), getattr(self, "_pass", 0)))
        shards = list(self.shards)
        if self.shuffle_buffer:
            rng.shuffle(shards)
        buf: List[Dict[str, object]] = []
        for shard in shards:
            for s in iter_tar_samples(shard):
                if not self.shuffle_buffer:
                    yield s
                    continue
                buf.append(s)
                if len(buf) >= self.shuffle_buffer:
                    idx = rng.integers(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
        while buf:  # drained with the same Generator
            idx = rng.integers(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()

    def _prepare(self, s: Dict[str, object]) -> Optional[Dict[str, object]]:
        out: Dict[str, object] = {"key": s["__key__"]}
        if self.mode in ("image", "pair"):
            img_bytes = next((s[e] for e in IMAGE_EXTS if e in s), None)
            if img_bytes is None:
                return None
            img = _decode_image(img_bytes)
            if self.transform is not None:
                img = self.transform(img)
            out["image"] = np.asarray(img, np.float32)
        if self.mode in ("text", "pair"):
            if "txt" not in s:
                return None
            out["text"] = s["txt"].decode("utf-8", errors="replace")
        return out

    def __iter__(self):
        self._pass = 0
        while True:
            yield from self._iter_once()
            if not self.repeat:
                return
            self._pass += 1

    def _iter_once(self):
        batch: List[Dict[str, object]] = []
        for s in self._samples():
            p = self._prepare(s)
            if p is None:
                continue
            batch.append(p)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_partial:
            yield self._collate(batch)

    def _collate(self, batch: List[Dict[str, object]]):
        out: Dict[str, object] = {"key": [b["key"] for b in batch]}
        if "image" in batch[0]:
            out["image"] = np.stack([b["image"] for b in batch])
        if "text" in batch[0]:
            texts = [b["text"] for b in batch]
            out["text"] = self.tokenizer(texts) if self.tokenizer is not None else texts
        return out


class CC3MDataModule(ClassificationDataModule):
    """Image-text pairs of CC3M: train and val pipelines in "pair" mode, the
    captions tokenized with CLIP's tokenizer."""

    NUM_CLASSES = -1  # image-text pairs, no labels

    TRAIN_SHARDS = "training/{00000..00331}.tar"
    VAL_SHARDS = "validation/{00000..00001}.tar"

    def __init__(self, config):
        if config.get("split_shards_by_process", False):
            raise NotImplementedError(
                "data.split_shards_by_process is not ported yet; it comes in "
                f"{SPLIT_BY_PROCESS_SLICE}")
        super().__init__(config)

    def setup(self, stage: Optional[str] = None):
        root = self.config.get("data_root") or settings.CC3M_PATH
        assert root, "Set CC3M_PATH"
        from bcosification_tpu_torch.clip.tokenizer import tokenize

        def shards(pattern):
            return expand_shard_pattern(os.path.join(root, pattern))

        if stage in (None, "fit", "train"):
            self.train_dataset = WdsPipeline(
                shards(self.TRAIN_SHARDS), self.batch_size, mode="pair",
                transform=self.config["train_transform"], tokenizer=tokenize,
                shuffle_buffer=self.config.get("shuffle_buffer", 1000))
        self.eval_dataset = WdsPipeline(
            shards(self.VAL_SHARDS), self.batch_size, mode="pair",
            transform=self.config["test_transform"], tokenizer=tokenize)

    def train_dataloader(self, seed: int = 0):
        # the run's seed keys the shard order and the shuffle-buffer draws
        self.train_dataset.seed = int(seed)
        return self.train_dataset

    def val_dataloader(self):
        return self.eval_dataset

    test_dataloader = val_dataloader
