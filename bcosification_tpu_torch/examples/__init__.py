"""Runnable examples of the port (counterparts of the repository's
``examples/``), each run as ``python -m bcosification_tpu_torch.examples.<name>``."""
