"""Host-side image and batch transforms (numpy + PIL, channel-last [H, W, C]).

A copy of ``bcosification_tpu/data/transforms.py``: images stay float32
numpy [H, W, C] in [0, 1] until the batch is moved to the card.

Single-image transforms take and return np.ndarray [H, W, C] (PIL images
are accepted at the head of a pipeline); the batch transforms (Mixup,
Cutmix, SplitAndGrid) act on (batch [N, H, W, C], target) pairs at collate
time (``datamodules.py``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

__all__ = [
    "Compose",
    "ToFloatArray",
    "Resize",
    "CenterCrop",
    "RandomResizedCrop",
    "RandomHorizontalFlip",
    "Normalize",
    "AddInverse",
    "BcosifyNormalize",
    "RandomMixup",
    "RandomCutmix",
    "SplitAndGrid",
    "one_hot_np",
    "set_sample_rng",
]

# Per-thread deterministic rng context: the DataLoader installs a Generator
# derived from (seed, epoch, position) before each sample/collate call so
# augmentation draws are reproducible, and identical across the processes
# of a multi-process run. Transforms fall back to fresh OS entropy when
# neither an explicit rng nor a context is set.
_thread_ctx = threading.local()


def set_sample_rng(rng: Optional[np.random.Generator]) -> None:
    """Install (or clear with None) the current thread's transform rng."""
    _thread_ctx.rng = rng


def _ctx_rng() -> Optional[np.random.Generator]:
    return getattr(_thread_ctx, "rng", None)


def _to_pil(img):
    if Image is not None and isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr)


def _to_float_array(img) -> np.ndarray:
    if Image is not None and isinstance(img, Image.Image):
        arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return arr
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr.astype(np.float32)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img

    def __repr__(self):
        return f"Compose({self.transforms})"


class ToFloatArray:
    """PIL/uint8 -> float32 [H,W,C] in [0,1] (PILToTensor+ConvertImageDtype)."""

    def __call__(self, img):
        return _to_float_array(img)


@dataclasses.dataclass
class Resize:
    """torchvision Resize(size:int) semantics: shorter side -> size, bilinear."""

    size: int
    interpolation: str = "bilinear"

    def __call__(self, img):
        pil = _to_pil(img)
        w, h = pil.size
        if w <= h:
            nw, nh = self.size, max(1, int(round(h * self.size / w)))
        else:
            nh, nw = self.size, max(1, int(round(w * self.size / h)))
        resample = {
            "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
            "nearest": Image.NEAREST,
        }[self.interpolation]
        return pil.resize((nw, nh), resample)


@dataclasses.dataclass
class CenterCrop:
    size: int

    def __call__(self, img):
        arr = img
        if Image is not None and isinstance(img, Image.Image):
            w, h = img.size
            left = int(round((w - self.size) / 2.0))
            top = int(round((h - self.size) / 2.0))
            return img.crop((left, top, left + self.size, top + self.size))
        h, w = arr.shape[:2]
        top = int(round((h - self.size) / 2.0))
        left = int(round((w - self.size) / 2.0))
        return arr[top : top + self.size, left : left + self.size]


@dataclasses.dataclass
class RandomResizedCrop:
    """torchvision RandomResizedCrop (scale (0.08,1), ratio (3/4,4/3))."""

    size: int
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    interpolation: str = "bilinear"
    rng: Optional[np.random.Generator] = None

    def __call__(self, img):
        rng = self.rng or _ctx_rng() or np.random.default_rng()
        pil = _to_pil(img)
        w, h = pil.size
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                break
        else:  # fallback: center crop to in-range aspect
            in_ratio = w / h
            if in_ratio < self.ratio[0]:
                cw, ch = w, int(round(w / self.ratio[0]))
            elif in_ratio > self.ratio[1]:
                ch, cw = h, int(round(h * self.ratio[1]))
            else:
                cw, ch = w, h
            left, top = (w - cw) // 2, (h - ch) // 2
        resample = {
            "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
            "nearest": Image.NEAREST,
        }[self.interpolation]
        return pil.resize(
            (self.size, self.size), resample, box=(left, top, left + cw, top + ch)
        )


@dataclasses.dataclass
class RandomHorizontalFlip:
    p: float = 0.5
    rng: Optional[np.random.Generator] = None

    def __call__(self, img):
        rng = self.rng or _ctx_rng() or np.random.default_rng()
        if rng.random() < self.p:
            if Image is not None and isinstance(img, Image.Image):
                return img.transpose(Image.FLIP_LEFT_RIGHT)
            return np.ascontiguousarray(img[:, ::-1])
        return img


@dataclasses.dataclass
class Normalize:
    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, arr):
        arr = _to_float_array(arr)
        return (arr - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32
        )


class AddInverse:
    """[r,g,b] -> [r,g,b,1-r,1-g,1-b] on the channel (last) axis
    (transforms.py:42-55)."""

    def __call__(self, arr):
        arr = _to_float_array(arr)
        return np.concatenate([arr, 1.0 - arr], axis=-1)


@dataclasses.dataclass
class BcosifyNormalize:
    """normalize then append the negated channels (transforms.py:9-40)."""

    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def __call__(self, arr):
        normed = Normalize(self.mean, self.std)(arr)
        return np.concatenate([normed, -normed], axis=-1)


def one_hot_np(target: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    out = np.zeros((*target.shape, num_classes), dtype)
    np.put_along_axis(out, target[..., None].astype(np.int64), 1.0, axis=-1)
    return out


@dataclasses.dataclass
class RandomMixup:
    """Batch-level mixup (transforms.py:101-170 / torchvision reference):
    rolls the batch by one and mixes with lambda ~ Beta(alpha, alpha)."""

    num_classes: int
    p: float = 0.5
    alpha: float = 1.0
    rng: Optional[np.random.Generator] = None

    def __call__(self, batch: np.ndarray, target: np.ndarray):
        rng = self.rng or _ctx_rng() or np.random.default_rng()
        if target.ndim == 1:
            target = one_hot_np(target, self.num_classes, batch.dtype)
        if rng.random() >= self.p:
            return batch, target
        lam = float(rng.beta(self.alpha, self.alpha))
        rolled = np.roll(batch, 1, axis=0)
        rolled_t = np.roll(target, 1, axis=0)
        batch = batch * lam + rolled * (1.0 - lam)
        target = target * lam + rolled_t * (1.0 - lam)
        return batch, target


@dataclasses.dataclass
class RandomCutmix:
    """Batch-level cutmix (torchvision reference semantics)."""

    num_classes: int
    p: float = 0.5
    alpha: float = 1.0
    rng: Optional[np.random.Generator] = None

    def __call__(self, batch: np.ndarray, target: np.ndarray):
        rng = self.rng or _ctx_rng() or np.random.default_rng()
        if target.ndim == 1:
            target = one_hot_np(target, self.num_classes, batch.dtype)
        if rng.random() >= self.p:
            return batch, target
        lam = float(rng.beta(self.alpha, self.alpha))
        n, h, w, c = batch.shape
        r_x, r_y = int(rng.integers(w)), int(rng.integers(h))
        r = 0.5 * math.sqrt(1.0 - lam)
        r_w_half, r_h_half = int(r * w), int(r * h)
        x1, y1 = max(r_x - r_w_half, 0), max(r_y - r_h_half, 0)
        x2, y2 = min(r_x + r_w_half, w), min(r_y + r_h_half, h)
        rolled = np.roll(batch, 1, axis=0)
        batch = batch.copy()
        batch[:, y1:y2, x1:x2, :] = rolled[:, y1:y2, x1:x2, :]
        lam_adj = 1.0 - (x2 - x1) * (y2 - y1) / (w * h)
        rolled_t = np.roll(target, 1, axis=0)
        target = target * lam_adj + rolled_t * (1.0 - lam_adj)
        return batch, target


@dataclasses.dataclass
class SplitAndGrid:
    """Grid-pointing-game training aug (transforms.py:58-99): gridifies a
    fraction p of the batch into 2x2 mosaics (bilinear-resized back to the
    original resolution) with multi-hot targets."""

    p_gridified: float
    num_classes: int

    @staticmethod
    def _make_grids(imgs: np.ndarray) -> np.ndarray:
        n, h, w, c = imgs.shape
        grids = []
        for i in range(0, (n // 4) * 4, 4):
            top = np.concatenate([imgs[i], imgs[i + 1]], axis=1)
            bottom = np.concatenate([imgs[i + 2], imgs[i + 3]], axis=1)
            grid = np.concatenate([top, bottom], axis=0)  # [2h, 2w, c]
            grids.append(_bilinear_resize(grid, (h, w)))
        return np.stack(grids) if grids else imgs[:0]

    def __call__(self, batch: np.ndarray, target: np.ndarray):
        if target.ndim == 1:
            target = one_hot_np(target, self.num_classes, batch.dtype)
        n = int(len(batch) * self.p_gridified)
        n = (n // 4) * 4
        if n == 0:
            return batch, target
        grids = self._make_grids(batch[:n])
        t = target[:n].reshape(n // 4, 4, -1).sum(1).clip(0, 1)
        return (
            np.concatenate([grids, batch[n:]], axis=0),
            np.concatenate([t, target[n:]], axis=0),
        )


def _bilinear_resize(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a float [H,W,C] array (align_corners=False)."""
    h, w, c = arr.shape
    oh, ow = size
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = arr[y0][:, x0]
    b = arr[y0][:, x1]
    c_ = arr[y1][:, x0]
    d = arr[y1][:, x1]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c_ * wy * (1 - wx) + d * wy * wx
    ).astype(arr.dtype)
