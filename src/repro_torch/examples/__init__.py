"""Examples of the PyTorch/CUDA port, run as modules
(``python -m repro_torch.examples.distributed_stencil``); the counterparts
of the JAX package's top-level ``examples/`` scripts."""
