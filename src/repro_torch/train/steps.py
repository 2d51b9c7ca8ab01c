"""Train / eval / serve steps of the port (the counterpart of
``repro.train.steps``), shared by the trainer and the tests.

The train step is ``torch.autograd.grad`` of ``model.loss_fn`` over the
parameter tree's leaves (JAX: ``jax.value_and_grad``), then one AdamW
update, which writes the parameters and moments in place."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model
from repro_torch.models.base import _unflatten, named_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import compress as compress_lib


def _detached(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def value_and_grad(model: Model, params, batch):
    """((loss, aux), grads) of ``model.loss_fn`` at ``params``: grads a tree
    like ``params`` (zeros for a leaf the loss does not reach, as in JAX)."""
    named = list(named_leaves(params))
    live = [p.detach().requires_grad_(True) for _, p in named]
    tree = _unflatten(params, {n: t for (n, _), t in zip(named, live)})
    with torch.enable_grad():
        loss, aux = model.loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    aux = {k: _detached(v) for k, v in aux.items()}
    return (loss.detach(), aux), _unflatten(params, {n: g for (n, _), g in zip(named, grads)})


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    grad_compression: Optional[str] = None):
    """Returns train_step(params, opt_state, batch) -> (params, state, metrics).

    ``grad_compression="int8"`` passes the gradients through int8
    quantize/dequantize with stochastic rounding (see parallel.compress) --
    a data-parallel all-reduce would then move int8 bytes."""

    def train_step(params, opt_state, batch):
        (loss, aux), grads = value_and_grad(model, params, batch)
        if grad_compression == "int8":
            grads = compress_lib.fake_quantize_tree(grads)
        params2, opt_state2, om = adamw.apply(opt_cfg, grads, opt_state, params)
        metrics = {"loss": loss, **aux, **om}
        return params2, opt_state2, metrics

    return train_step


def make_serve_step(model: Model):
    """One-token greedy decode step (the unit the decode cells lower)."""

    def serve_step(params, caches, token, pos):
        with torch.no_grad():
            return model.decode_step(params, caches, token, pos)

    return serve_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, aux = model.loss_fn(params, batch)
        return {"loss": loss, **aux}

    return eval_step
