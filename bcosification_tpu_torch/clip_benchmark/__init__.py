"""The CLIP benchmark harness on PyTorch (the port of the JAX package's
top-level ``clip_benchmark``, module for module): ``python -m
bcosification_tpu_torch.clip_benchmark.cli eval ...`` runs zero-shot
classification, linear probe, retrieval, caption selection and captioning
on the GPU (``main(argv, device="cpu")`` on the CPU)."""
