"""The input pipeline: ImageFolder and numpy datasets, CC3M's tar shards,
transforms and presets, the threaded loader and the data-module registry
(the port's copies of ``bcosification_tpu/data``)."""
from bcosification_tpu_torch.data import cc3m  # noqa: F401  (registers CC3MDataModule)
