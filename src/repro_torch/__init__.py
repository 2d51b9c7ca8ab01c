"""PyTorch and CUDA port of the stencil system for NVIDIA Hopper (H100).

Mirrors the JAX package ``repro`` module by module and imports nothing of
it: ``repro_torch.stencil`` (specs, weights, oracles), ``repro_torch.core``
(performance model and selector) and ``repro_torch.kernels`` (the CUDA
kernels and the plan API).  Entry points run on the card unless the caller
passes ``device="cpu"``."""
from . import core, kernels, stencil
from .kernels import explain, stencil_apply, stencil_plan

__all__ = ["core", "kernels", "stencil", "explain", "stencil_apply",
           "stencil_plan"]
