"""The port's LLM configs, parameter trees and model interface
(``repro_torch.configs``, ``repro_torch.models.base`` / ``api``) against
the JAX package's, on the CPU: the same configs field for field, the same
parameter names, shapes and counts at full width, JAX's init distributions,
the copy of a JAX parameter tree, the serving dtype, meta input specs, and
no import of JAX or the JAX package."""
import dataclasses
import importlib
import math
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import get_model as jax_get_model
from repro_torch.configs import registry as reg
from repro_torch.models import base
from repro_torch.models.api import get_model
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(reg.ARCHS)


def test_registry_matches_jax():
    assert sorted(reg.ARCHS) == sorted(jreg.ARCHS)
    assert sorted(reg.SMOKE) == sorted(jreg.SMOKE)
    for name in jreg.ARCHS:
        for ours, theirs in ((reg.ARCHS[name], jreg.ARCHS[name]),
                             (reg.SMOKE[name], jreg.SMOKE[name])):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
            assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert reg.cells_for(name) == jreg.cells_for(name)
        assert reg.get(name, smoke=True) == reg.SMOKE[name]
    assert {k: dataclasses.asdict(v) for k, v in reg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_shims(arch):
    stem = arch.replace(".", "_").replace("-", "_")
    ours = importlib.import_module(f"repro_torch.configs.{stem}")
    theirs = importlib.import_module(f"repro.configs.{stem}")
    assert ours.ARCH == theirs.ARCH == arch
    assert dataclasses.asdict(ours.FULL) == dataclasses.asdict(theirs.FULL)
    assert dataclasses.asdict(ours.SMOKE_CFG) == dataclasses.asdict(theirs.SMOKE_CFG)
    assert sorted(ours.CELLS) == sorted(theirs.CELLS)


def _jax_named_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_matches_jax(arch):
    """Names (JAX tree paths joined by '.'), shapes, logical axes and the
    count at full width, from the definitions alone."""
    jm, m = jax_get_model(jreg.ARCHS[arch]), get_model(reg.ARCHS[arch])
    ours = {n: tuple(t.shape) for n, t in base.named_leaves(m.param_shapes())}
    assert ours == _jax_named_shapes(jm.param_shapes())
    assert list(ours) == list(_jax_named_shapes(jm.param_shapes()))   # leaf order
    assert m.param_count() == jm.param_count()
    jaxes = jax.tree.leaves(jax.tree.map(lambda d: d.axes, jm.param_defs(),
                                         is_leaf=lambda x: hasattr(x, "axes")),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert [a for _, a in base.named_leaves(base.axes_tree(m.param_defs()))] == jaxes
    assert all(t.device.type == "meta" for _, t in base.named_leaves(m.param_shapes()))


def test_init_follows_jax_distributions():
    """zeros / ones exact; 'normal' leaves N(0, scale/sqrt(fan_in)) with
    fan_in = shape[-2] (JAX's convention, the stacked axis aside); 'embed'
    N(0, scale).  Checked on qwen3's SMOKE tree, whose expert weights give
    every normal leaf thousands of draws."""
    cfg = reg.SMOKE["qwen3-moe-235b-a22b"]
    m = get_model(cfg)
    defs = dict(base.named_leaves(m.param_defs()))
    params = dict(base.named_leaves(m.init_params(torch.Generator().manual_seed(3))))
    assert params.keys() == defs.keys()
    for name, d in defs.items():
        p = params[name]
        assert p.dtype == torch.float32 and tuple(p.shape) == d.shape
        if d.init in ("zeros", "ones"):
            assert torch.equal(p, torch.full(d.shape, float(d.init == "ones")))
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "embed" else d.scale / math.sqrt(max(1, fan_in))
        n = p.numel()
        assert abs(float(p.mean())) < 5 * std / math.sqrt(n), name
        assert abs(float(p.std()) / std - 1) < 5 * math.sqrt(2.0 / n), name
    again = dict(base.named_leaves(m.init_params(torch.Generator().manual_seed(3))))
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_params_from_numpy_is_a_plain_copy():
    cfg = reg.SMOKE["zamba2-1.2b"]
    jp = jax_get_model(cfg).init_params(jax.random.PRNGKey(0))
    tree = base.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ours = dict(base.named_leaves(tree))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(ours) == len(flat)
    for path, leaf in flat:
        name = ".".join(str(k.key) for k in path)
        assert np.array_equal(ours[name].numpy(), np.asarray(leaf)), name
    # bf16 leaves (a JAX cache tree at the config dtype) arrive exactly
    x = np.asarray(jax.numpy.asarray([1.5, -2.25, 3e-3], jax.numpy.bfloat16))
    t = base.params_from_numpy({"k": x}, "cpu")["k"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), x.astype(np.float32))


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        base.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        base.resolve_device(None)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "llama3.2-1b"])
def test_serving_params_cast_once(arch):
    """Every leaf the models cast to cfg.dtype at each use is stored in
    bf16 once (the same bits as the cast); the leaves JAX reads in f32 stay
    f32; a float32 config is left as it is."""
    cfg = reg.SMOKE[arch]
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    served = base.serving_params(params, cfg)
    for (name, p), (_, s) in zip(base.named_leaves(params), base.named_leaves(served)):
        if name.split(".")[-1] in base.KEEP_F32:
            assert s.dtype == torch.float32 and torch.equal(s, p), name
        else:
            assert s.dtype == torch.bfloat16 and torch.equal(s, p.to(torch.bfloat16)), name
    f32 = dataclasses.replace(cfg, dtype="float32")
    kept = base.serving_params(params, f32)
    assert all(k is p for (_, k), (_, p) in zip(base.named_leaves(kept),
                                                 base.named_leaves(params)))


@pytest.mark.parametrize("arch,cell", [(a, c) for a in ARCHS for c in jreg.cells_for(a)])
def test_input_specs_match_jax(arch, cell):
    """Meta tensors with the shapes and dtypes of JAX's ShapeDtypeStructs
    (decode: the caches at full length, by ``jax.eval_shape``)."""
    jspec = jax_get_model(jreg.ARCHS[arch]).input_specs(jreg.SHAPES[cell])
    spec = get_model(reg.ARCHS[arch]).input_specs(reg.SHAPES[cell])
    jflat = jax.tree_util.tree_flatten_with_path(jspec)[0]
    ours = dict(base.named_leaves(spec))
    assert len(ours) == len(jflat)
    for path, leaf in jflat:
        t = ours[".".join(str(k.key) for k in path)]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(leaf.shape)
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)


_IMPORTS = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "src" / "repro_torch" / "configs").glob("*.py"))
    + list((ROOT / "src" / "repro_torch" / "models").glob("*.py"))
    + [ROOT / "src" / "repro_torch" / "launch" / "serve.py"]))
def test_llm_path_imports_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORTS.search(text), path
    assert "jax" not in re.findall(r"import_module\(\s*['\"](\w+)", text)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_is_the_argmax_of_decode_logits(arch):
    """``Model.decode_step`` (the family's ``decode_step``, JAX's API) gives
    the argmax of ``decode_logits`` as int32 and the same caches, from two
    copies of the same caches; ``decode_logits`` writes its caches in
    place where the family keeps a KV cache."""
    cfg = reg.SMOKE[arch]
    m = get_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0))
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    a, b = m.init_caches(2, 6, "cpu"), m.init_caches(2, 6, "cpu")
    with torch.no_grad():
        for pos in range(3):
            nxt, a = m.decode_step(params, a, tok, pos)
            logits, b = m.decode_logits(params, b, tok, pos)
            assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
            assert torch.equal(nxt, torch.argmax(logits, -1).to(torch.int32))
            for (na, ta), (nb, tb) in zip(base.named_leaves(a), base.named_leaves(b)):
                assert na == nb and torch.equal(ta, tb), na
            tok = nxt
