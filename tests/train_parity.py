"""Shared helpers of the training parity tests (``tests/test_torch_train_*.py``):
the JAX package's training path against the port's on the CPU, from the same
numpy parameters and inputs.  Configs, inputs and bounds come from
``llm_parity``: float32 within ``F32_TOL * max(1, max|ref|)``, bfloat16
within twice JAX's own bf16-vs-f32 error on the same quantity.

``TINY`` is the JAX loop tests' model (``tests/test_train_loop.py``)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import llm_parity as lp
from repro.configs.registry import ModelConfig as JaxModelConfig
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.registry import ModelConfig
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.train import steps

TINY = ModelConfig("loop-tiny", "dense", 2, 32, 2, 1, 64, 128, rope_theta=10000.0)
JAX_TINY = JaxModelConfig("loop-tiny", "dense", 2, 32, 2, 1, 64, 128, rope_theta=10000.0)


def jax_params(jcfg, seed: int = lp.PARAM_SEED):
    """JAX's initial parameters of ``jcfg`` as numpy copies (JAX's loop
    donates the arrays it is given)."""
    params = jax_get_model(jcfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.array(a, copy=True), params)


class GradReferences:
    """JAX's ``value_and_grad(model.loss_fn)`` per (SMOKE arch, dtype) from
    the same parameters (JAX's seed-0 init, numpy) and ``llm_parity``'s
    inputs, computed on first use."""

    def __init__(self):
        self._refs = {}

    def __call__(self, arch: str, dtype: str) -> dict:
        if (arch, dtype) not in self._refs:
            jcfg, _ = lp.configs(arch, dtype)
            model = jax_get_model(jcfg)
            params = jax_params(jcfg)
            inp = lp.make_inputs(jcfg)
            f = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
            (loss, aux), grads = f(jax.tree.map(jnp.asarray, params),
                                   {k: jnp.asarray(v) for k, v in inp.items()})
            self._refs[arch, dtype] = {
                "params": params, "inputs": inp, "loss": float(loss),
                "aux": {k: float(v) for k, v in aux.items()},
                "grads": jax.tree.map(lambda a: np.asarray(a, np.float32), grads)}
        return self._refs[arch, dtype]


def port_grads(cfg, params_np, inputs):
    """((loss, aux), grads) of the port's ``loss_fn`` on the CPU."""
    params = base.params_from_numpy(params_np, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return steps.value_and_grad(get_model(cfg), params, batch)


def check_grads(got, ref, ref32, what: str):
    """Every gradient leaf within ``llm_parity``'s bound of JAX's."""
    leaves32 = dict(base.named_leaves(ref32)) if ref32 is not None else {}
    names = [n for n, _ in base.named_leaves(ref)]
    assert [n for n, _ in base.named_leaves(got)] == names, what
    for (name, g), (_, r) in zip(base.named_leaves(got), base.named_leaves(ref)):
        lp.assert_close(lp.as_numpy(g), r, leaves32.get(name), f"{what} {name}")


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")
