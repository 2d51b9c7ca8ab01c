"""AdamW + global-norm clipping + LR schedules of the port (the counterpart
of ``repro.optim.adamw``), over nested dicts of tensors.

JAX's formula, which ``torch.optim.AdamW`` is not:
  * ``apply`` raises the step before the schedule, and the warm-up reads
    ``step + 1``, so the first update runs at ``lr * 2 / warmup_steps``;
  * weight decay is added to the Adam direction and scaled by ``lr``, on
    every leaf (norms and embeddings too);
  * clipping is by the global norm, with 1e-9 added to it;
  * the moments are float32 whatever the leaf's dtype.

``apply`` updates the parameters and both moments in place under
``torch.no_grad()`` and returns them (JAX donates them to its jitted step;
functional copies would add a parameter tree and two moment trees at once).
The step counter is an int32 tensor on the host: the schedule and the bias
corrections are computed there in float32, as JAX computes them, so an
update needs no read back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.base import named_leaves, params_from_numpy, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"      # cosine | constant


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32, 0-d, on the host
    m: Any
    v: Any


def init(params) -> AdamWState:
    # zeros_like: a DTensor leaf gets moments with its own placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(torch.zeros((), dtype=torch.int32),
                      tree_map(zeros, params), tree_map(zeros, params))


def state_from_numpy(state, device=None) -> AdamWState:
    """A JAX ``AdamWState`` passed through ``np.asarray`` (any (step, m, v)
    triple of numpy trees) as the port's: the step on the host, the moments
    on ``device`` (default the card)."""
    step, m, v = state
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                      params_from_numpy(m, device), params_from_numpy(v, device))


def _f32(x) -> np.float32:
    return np.float32(x)


def lr_at(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (an int or a 0-d tensor), in float32."""
    step = _f32(int(step))
    warm = np.minimum(_f32(1.0), (step + _f32(1)) / _f32(max(1, cfg.warmup_steps)))
    if cfg.schedule == "constant":
        return float(_f32(cfg.lr) * warm)
    frac = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(1, cfg.total_steps - cfg.warmup_steps)), _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * frac))
    return float(_f32(cfg.lr) * warm * (_f32(0.1) + _f32(0.9) * cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, summed in
    JAX's leaf order (a 0-d tensor on the leaves' device)."""
    total = None
    for _, x in named_leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def apply(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW update.  Returns (new_params, new_state, metrics); the
    parameters and moments are updated in place, ``grads`` are not."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm) if cfg.clip_norm is not None else None
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = float(_f32(1.0) - _f32(cfg.b1) ** _f32(int(step)))
    b2c = float(_f32(1.0) - _f32(cfg.b2) ** _f32(int(step)))

    flat_g = [g for _, g in named_leaves(grads)]
    flat_m = [m for _, m in named_leaves(state.m)]
    flat_v = [v for _, v in named_leaves(state.v)]
    flat_p = [p for _, p in named_leaves(params)]
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p, strict=True):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        den = torch.div(v, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(den)
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta, alpha=lr)
        else:
            p.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}
