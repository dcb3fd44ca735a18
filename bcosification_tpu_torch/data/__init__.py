"""The input pipeline: ImageFolder and numpy datasets, transforms and
presets, the threaded loader and the data-module registry (the port's
copies of ``bcosification_tpu/data``)."""
