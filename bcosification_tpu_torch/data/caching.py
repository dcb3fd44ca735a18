"""Dataset caching (a copy of ``bcosification_tpu/data/caching.py``): a
decoded-image cache. Each image is resized once to the eval geometry and
stored as uint8 in one memory-mapped file, so later epochs read it with no
JPEG decode.

``cache_dataset='onthefly'`` fills the cache lazily during the first pass;
``'shm'`` places the cache file in /dev/shm.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from bcosification_tpu_torch import settings

__all__ = ["CachedImageFolder"]


class CachedImageFolder:
    """Wraps an ImageFolder-style dataset with an mmap'd decoded-uint8 cache.

    The cached representation is the *resized* image (shorter side =
    cache_size); the remaining transform (crop / flip / float / AddInverse)
    runs per epoch so train-time augmentation stays random.
    """

    def __init__(
        self,
        dataset,
        cache_size: int = 256,
        cache_dir: Optional[str] = None,
        transform: Optional[Callable] = None,
        use_shm: bool = False,
    ):
        self.dataset = dataset
        self.cache_size = cache_size
        self.transform = transform or getattr(dataset, "transform", None)
        base = (
            Path("/dev/shm/bcos_cache")
            if use_shm
            else Path(cache_dir or settings.LOCAL_CACHE_DIR)
        )
        base.mkdir(parents=True, exist_ok=True)
        key = hashlib.sha256(
            json.dumps(
                [getattr(dataset, "root", "?").__str__(), len(dataset), cache_size]
            ).encode()
        ).hexdigest()[:16]
        self._data_path = base / f"cache_{key}.u8"
        self._meta_path = base / f"cache_{key}.json"
        n = len(dataset)
        itemsize = cache_size * cache_size * 3
        self._itemsize = itemsize
        mode = "r+" if self._data_path.exists() else "w+"
        self._mm = np.memmap(
            self._data_path, dtype=np.uint8, mode=mode, shape=(n, itemsize)
        )
        if self._meta_path.exists():
            with open(self._meta_path) as f:
                self._filled = set(json.load(f))
        else:
            self._filled = set()
        self._fill_lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def _decode_resized(self, i) -> np.ndarray:
        from PIL import Image

        path, _ = self.dataset.samples[i]
        with Image.open(path) as img:
            img = img.convert("RGB")
            w, h = img.size
            s = self.cache_size
            if w <= h:
                nw, nh = s, max(1, round(h * s / w))
            else:
                nh, nw = s, max(1, round(w * s / h))
            img = img.resize((nw, nh), Image.BILINEAR)
            # center-crop to square cache geometry
            left, top = (nw - s) // 2, (nh - s) // 2
            img = img.crop((left, top, left + s, top + s))
            return np.asarray(img, np.uint8)

    def _get_cached(self, i) -> np.ndarray:
        # loader threads call this concurrently (ThreadPoolExecutor,
        # loader.py): guard the shared _filled set — an unlocked
        # sorted(self._filled) during a concurrent .add() raises "set
        # changed size during iteration" mid-epoch, and two simultaneous
        # checkpoint hits interleave writes to the meta file.
        # The decode itself stays outside the lock (it dominates the time
        # and touches only per-index state).
        if i not in self._filled:
            arr = self._decode_resized(i)
            self._mm[i] = arr.reshape(-1)
            with self._fill_lock:
                self._filled.add(i)
                checkpoint = (
                    len(self._filled) % 10000 == 0
                    or len(self._filled) == len(self)
                )
                snapshot = sorted(self._filled) if checkpoint else None
            if snapshot is not None:
                tmp = self._meta_path.with_suffix(f".tmp{os.getpid()}")
                with open(tmp, "w") as f:
                    json.dump(snapshot, f)
                tmp.replace(self._meta_path)
        s = self.cache_size
        return self._mm[i].reshape(s, s, 3)

    def __getitem__(self, i):
        img = self._get_cached(i)
        _, target = self.dataset.samples[i]
        if self.transform is not None:
            img = self.transform(img)
        return np.asarray(img, np.float32), np.int32(target)
