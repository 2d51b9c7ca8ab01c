"""Benchmarks of the PyTorch/CUDA port, run as modules
(``python -m repro_torch.benchmarks.serving``); the counterparts of the
JAX package's top-level ``benchmarks/`` scripts."""
