"""Gradient compression of the port (the counterpart of
``repro.parallel.compress``).

``fake_quantize_tree``: per-tensor symmetric int8 quantize -> dequantize of
every gradient leaf, placed on the output of the backward so that a
data-parallel all-reduce would move int8 bytes.  Stochastic rounding keeps
the quantizer unbiased, so SGD/Adam converge in expectation.

JAX draws its uniforms with threefry from ``PRNGKey(seed)`` split per leaf,
the same noise on every call; the port draws them leaf after leaf, in JAX's
leaf order, from a ``torch.Generator`` seeded with ``seed`` on every call:
the same noise on every call too, though not JAX's numbers.
``_quantize_with`` takes the uniforms, so JAX's can be fed to it.
"""
from __future__ import annotations

import torch

from repro_torch.models.base import _unflatten, named_leaves


def _quantize_with(x: torch.Tensor, rnd: torch.Tensor):
    """(int8 values, scale) of float32 ``x``, rounded down or up by the
    uniforms ``rnd`` (x's shape): floor + Bernoulli(frac)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    scaled = x / scale
    lo = torch.floor(scaled)
    frac = scaled - lo
    q = (lo + (rnd < frac)).to(torch.int8)
    return q, scale


def _quantize(x: torch.Tensor, generator: torch.Generator):
    rnd = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return _quantize_with(x, rnd)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quantize_tree(grads, seed: int = 0):
    """Every leaf of ``grads`` quantized to int8 and back, in its dtype."""
    leaves = dict(named_leaves(grads))
    device = next(iter(leaves.values())).device
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    for name, g in leaves.items():
        q, s = _quantize(g.float(), gen)
        out[name] = _dequantize(q, s).to(g.dtype)
    return _unflatten(grads, out)
