"""Paths set by environment variables: the same variables, with the same
meaning and defaults, as ``bcosification_tpu/settings.py``.

- ``IMAGENET_PATH``: an ImageFolder tree with ``train/`` and ``val/`` class
  folders;
- ``BCOS_EXPERIMENT_ROOT``: where experiments keep their checkpoints and
  metrics (``<root>/<dataset>/<base_network>/<experiment_name>``);
- ``BCOS_CACHE_DIR``: the decoded-image cache (``data/caching.py``);
- ``DATA_ROOT``: CIFAR10/100, FashionMNIST and STL10;
- ``VOC_PATH``: the VOC2007 tree of ``VOCDataModule``;
- ``CC3M_PATH``: the CC3M tar shards (``data/cc3m.py``);
- ``CLIP_WEIGHTS_PATH``: an OpenAI CLIP checkpoint (``clip/load.py``);
- ``BCOS_HUB_PATH``: the standard ViT weights of ``vit_bcosification``;
- ``CLIP_BPE_PATH`` and ``IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH``: as in the
  JAX package.

``TORCHVISION_WEIGHTS_DIR`` is read where the weights are loaded
(``experiments/ImageNet/bcosification/model.py``).
"""
import os

DATA_ROOT = os.getenv("DATA_ROOT")

IMAGENET_PATH = os.getenv("IMAGENET_PATH")
IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH = os.getenv("IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH")

VOC_PATH = os.getenv("VOC_PATH")

CC3M_PATH = os.getenv("CC3M_PATH")

LOCAL_CACHE_DIR = os.getenv("BCOS_CACHE_DIR", os.path.expanduser("~/.cache/bcos_tpu"))

EXPERIMENT_ROOT = os.getenv("BCOS_EXPERIMENT_ROOT", "./experiments")

CLIP_WEIGHTS_PATH = os.getenv("CLIP_WEIGHTS_PATH")
CLIP_BPE_PATH = os.getenv("CLIP_BPE_PATH")

BCOS_HUB_PATH = os.getenv("BCOS_HUB_PATH")
