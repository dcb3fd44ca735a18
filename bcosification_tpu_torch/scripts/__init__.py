"""The command-line tools of the port (counterparts of the repository's
``scripts/``), each run as ``python -m bcosification_tpu_torch.scripts.<name>``."""
