"""Transform presets (a copy of ``bcosification_tpu/data/presets.py``).

``is_bcos=True`` swaps Normalize for AddInverse; the CLIP presets keep raw
[0, 1] images (the network normalises them).
"""
from __future__ import annotations

from typing import Optional, Tuple

from bcosification_tpu_torch.data import transforms as T

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "CLIP_MEAN",
    "CLIP_STD",
    "ImageNetClassificationPresetTrain",
    "ImageNetClassificationPresetEval",
    "CLIPBcosImageNetClassificationPresetTrain",
    "CLIPBcosImageNetClassificationPresetEval",
    "CIFAR10ClassificationPresetTrain",
    "CIFAR10ClassificationPresetEval",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class _PresetBase:
    def __call__(self, img):
        return self.transforms(img)

    def __repr__(self):
        return f"{self.__class__.__name__}({self.transforms!r})"

    def __to_config__(self):
        return dict(transform=repr(self), **getattr(self, "args", {}))

    def with_args(self, **overrides):
        """Rebuild this preset with updated constructor args (the reference's
        transform-container `with_args`, used e.g. by the localisation
        analyser's rescale mode, localisation.py:256-265)."""
        return type(self)(**{**self.args, **overrides})


class ImageNetClassificationPresetTrain(_PresetBase):
    def __init__(
        self,
        *,
        crop_size,
        mean=IMAGENET_MEAN,
        std=IMAGENET_STD,
        interpolation="bilinear",
        hflip_prob=0.5,
        is_bcos=False,
    ):
        self.args = dict(
            crop_size=crop_size,
            interpolation=interpolation,
            hflip_prob=hflip_prob,
            is_bcos=is_bcos,
        )
        trans = [T.RandomResizedCrop(crop_size, interpolation=interpolation)]
        if hflip_prob > 0:
            trans.append(T.RandomHorizontalFlip(hflip_prob))
        trans.append(T.ToFloatArray())
        trans.append(T.AddInverse() if is_bcos else T.Normalize(mean, std))
        self.transforms = T.Compose(trans)


class ImageNetClassificationPresetEval(_PresetBase):
    def __init__(
        self,
        *,
        crop_size,
        resize_size=256,
        mean=IMAGENET_MEAN,
        std=IMAGENET_STD,
        interpolation="bilinear",
        is_bcos=False,
    ):
        self.args = dict(
            crop_size=crop_size,
            resize_size=resize_size,
            interpolation=interpolation,
            is_bcos=is_bcos,
        )
        self.transforms = T.Compose(
            [
                T.Resize(resize_size, interpolation=interpolation),
                T.CenterCrop(crop_size),
                T.ToFloatArray(),
                T.AddInverse() if is_bcos else T.Normalize(mean, std),
            ]
        )


class CLIPBcosImageNetClassificationPresetTrain(_PresetBase):
    """CLIP-KD train preset: raw [0,1] images (no normalise, no AddInverse —
    both happen inside the model branches, presets.py:13-80)."""

    def __init__(self, *, crop_size, interpolation="bilinear", hflip_prob=0.5):
        self.args = dict(
            crop_size=crop_size, interpolation=interpolation, hflip_prob=hflip_prob
        )
        trans = [T.RandomResizedCrop(crop_size, interpolation=interpolation)]
        if hflip_prob > 0:
            trans.append(T.RandomHorizontalFlip(hflip_prob))
        trans.append(T.ToFloatArray())
        self.transforms = T.Compose(trans)


class CLIPBcosImageNetClassificationPresetEval(_PresetBase):
    def __init__(self, *, crop_size, resize_size=256, interpolation="bilinear"):
        self.args = dict(
            crop_size=crop_size, resize_size=resize_size, interpolation=interpolation
        )
        self.transforms = T.Compose(
            [
                T.Resize(resize_size, interpolation=interpolation),
                T.CenterCrop(crop_size),
                T.ToFloatArray(),
            ]
        )


class CIFAR10ClassificationPresetTrain(_PresetBase):
    def __init__(self, *, is_bcos=True, mean=(0.4914, 0.4822, 0.4465),
                 std=(0.2470, 0.2435, 0.2616), hflip_prob=0.5):
        self.args = dict(is_bcos=is_bcos, hflip_prob=hflip_prob)
        trans = []
        if hflip_prob > 0:
            trans.append(T.RandomHorizontalFlip(hflip_prob))
        trans.append(T.ToFloatArray())
        trans.append(T.AddInverse() if is_bcos else T.Normalize(mean, std))
        self.transforms = T.Compose(trans)


class CIFAR10ClassificationPresetEval(_PresetBase):
    def __init__(self, *, is_bcos=True, mean=(0.4914, 0.4822, 0.4465),
                 std=(0.2470, 0.2435, 0.2616)):
        self.args = dict(is_bcos=is_bcos)
        self.transforms = T.Compose(
            [T.ToFloatArray(), T.AddInverse() if is_bcos else T.Normalize(mean, std)]
        )
