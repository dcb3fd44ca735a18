"""OpenAI CLIP's ImageNet zero-shot prompts: the 80 templates and the 1000
class names (a copy of ``bcosification_tpu/data/imagenet.py``; the asset
``data/assets/clip_imagenet_prompts.json`` is a copy of the JAX package's)."""
import json
from pathlib import Path

with open(Path(__file__).parent / "assets" / "clip_imagenet_prompts.json") as f:
    _data = json.load(f)

imagenet_templates = _data["templates"]
imagenet_classes = _data["classnames"]
