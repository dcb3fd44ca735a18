"""Named model collections for sweep runs.

Parity target: `CLIP_benchmark/clip_benchmark/
model_collection.py:6-29` (openai / openclip model lists) plus the
B-cosified experiment names shipped by this framework.
"""
from __future__ import annotations

model_collection = {
    "openai": [
        "RN50,openai",
        "RN101,openai",
        "RN50x4,openai",
        "ViT-B-32,openai",
        "ViT-B-16,openai",
        "ViT-L-14,openai",
    ],
    "bcos_clip": [
        "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification,",
        "resnet_50_clip_b2_noBias_randomResizedCrop_cyclicLR_sigLip_ImageNet_bcosification,",
    ],
    "bcos_clip_cc3m": [
        "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_kd_CC3M_bcosification,",
    ],
}


def get_model_collection_from_file(path: str):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
