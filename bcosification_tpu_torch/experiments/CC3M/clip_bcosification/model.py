"""CC3M's KD student is the one of ImageNet/clip_bcosification."""
from bcosification_tpu_torch.experiments.ImageNet.clip_bcosification.model import get_model

__all__ = ["get_model"]
