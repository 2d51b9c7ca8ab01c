"""The port's gradients (``repro_torch.train.steps.value_and_grad``) against
``jax.value_and_grad(model.loss_fn)`` on the CPU for every SMOKE arch, from
JAX's parameters and ``llm_parity``'s inputs: float32 within
``F32_TOL * max(1, max|g|)`` per leaf, bfloat16 within twice JAX's own
bf16-vs-f32 error on the same leaf (``llm_parity.bound``).  Then remat: the
layer bodies recomputed in the backward (``cfg.remat``) give the same
gradients bit for bit, and the per-layer views come from one unbind."""
import dataclasses

import numpy as np
import pytest
import torch

import llm_parity as lp
import train_parity as tp
from repro_torch.configs import SMOKE
from repro_torch.models import base
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = sorted(SMOKE)


@pytest.fixture(scope="module")
def refs():
    return tp.GradReferences()


@pytest.mark.parametrize("dtype", lp.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(refs, arch, dtype):
    ref = refs(arch, dtype)
    ref32 = refs(arch, "float32") if dtype != "float32" else None
    _, cfg = lp.configs(arch, dtype)
    (loss, aux), grads = tp.port_grads(cfg, ref["params"], ref["inputs"])
    what = f"{arch} {dtype}"
    lp.assert_close(float(loss), ref["loss"], None if ref32 is None else ref32["loss"],
                    f"{what} loss")
    assert aux.keys() == ref["aux"].keys()
    for k, v in aux.items():
        lp.assert_close(float(v), ref["aux"][k],
                        None if ref32 is None else ref32["aux"][k], f"{what} {k}")
    tp.check_grads(grads, ref["grads"], None if ref32 is None else ref32["grads"],
                   f"{what} grad")


@pytest.mark.parametrize("dtype", lp.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal_bit_for_bit(arch, dtype):
    """cfg.remat recomputes each layer body in the backward; on the CPU the
    recomputed activations are the same bits, so are the gradients."""
    _, cfg = lp.configs(arch, dtype)
    params = tp.jax_params(lp.configs(arch, "float32")[0])
    inputs = lp.make_inputs(cfg, seed=3)
    outs = {}
    for remat in (True, False):
        (loss, _), grads = tp.port_grads(dataclasses.replace(cfg, remat=remat),
                                         params, inputs)
        outs[remat] = (loss, grads)
    assert torch.equal(outs[True][0], outs[False][0])
    for (name, a), (_, b) in zip(base.named_leaves(outs[True][1]),
                                 base.named_leaves(outs[False][1])):
        assert torch.equal(a, b), f"{arch} {dtype} {name}"


def test_remat_only_under_autograd(monkeypatch):
    """The checkpoint runs where autograd records and cfg.remat asks for
    it; under ``torch.no_grad()`` (the serving path) the body runs as is."""
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(base, "checkpoint", counting)
    cfg = dataclasses.replace(SMOKE["llama3.2-1b"], dtype="float32")
    params = tp.jax_params(lp.configs("llama3.2-1b", "float32")[0])
    inputs = lp.make_inputs(cfg)
    with torch.no_grad():
        lp.port_loss(cfg, base.params_from_numpy(params, "cpu"), inputs)
    assert calls == []
    tp.port_grads(cfg, params, inputs)
    # the layer bodies, one attention chunk each (again when the backward
    # recomputes its body), one cross-entropy chunk
    assert calls.count("_train_block") == cfg.n_layers
    assert calls.count("one_chunk") == 2 * cfg.n_layers and calls.count("one") == 1
    calls.clear()
    tp.port_grads(dataclasses.replace(cfg, remat=False), params, inputs)
    assert "_train_block" not in calls and calls.count("one") == 1


def test_layers_of_are_views_from_one_unbind():
    stacked = {"a": torch.arange(24.0).reshape(3, 8), "b": {"c": torch.ones(3, 2, 2)}}
    layers = base.layers_of(stacked)
    assert len(layers) == 3
    for i, lay in enumerate(layers):
        assert torch.equal(lay["a"], stacked["a"][i])
        assert lay["a"].data_ptr() == stacked["a"][i].data_ptr()
        assert lay["b"]["c"].data_ptr() == stacked["b"]["c"][i].data_ptr()
    # the backward of the views is one stack, no per-layer zero tensor
    leaf = torch.randn(4, 5, requires_grad=True)
    parts = base.layers_of({"w": leaf})
    loss = sum((k + 1) * p["w"].sum() for k, p in enumerate(parts))
    (g,) = torch.autograd.grad(loss, leaf)
    np.testing.assert_array_equal(g.numpy(), np.repeat(np.arange(1, 5.0)[:, None], 5, 1))
    assert g.grad_fn is None
