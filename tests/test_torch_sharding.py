"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's (``repro.parallel.sharding``), on the CPU.

JAX's ``make_rules`` / ``resolve_axes`` read only a mesh's ``shape`` (a name
-> size mapping) and ``axis_names``, and so do the port's, so one stub mesh
serves both packages and no devices are needed.  For every arch at full
width (shapes only) on the (16, 16) and (2, 16, 16) production meshes, with
``fsdp`` on and off and with ``pure_dp``, the port's parameter specs equal
JAX's ``PartitionSpec``s entry for entry; so do the decode-state and batch
specs.  Then the spec -> DTensor placements map, and ``logical`` /
``gathered`` off a mesh: the input object itself."""
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models.api import get_model as jax_get_model
from repro.parallel import sharding as jsh
from repro_torch.configs.registry import ARCHS, SHAPES
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding
from torch_threads import one_intra_op_thread  # noqa: F401

MESHES = {
    "single": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                    axis_names=("data", "model")),
    "multi": types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                   axis_names=("pod", "data", "model")),
    "2x2": types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model")),
}
POLICIES = [(False, False), (True, False), (True, True), (False, True)]


def _jax_tree(specs) -> dict:
    """JAX's spec tree as {dotted path: tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {".".join(str(k.key) for k in path): tuple(spec) for path, spec in flat}


def _port_tree(specs) -> dict:
    return dict(base.named_leaves(specs))


@pytest.mark.parametrize("fsdp,pure_dp", POLICIES)
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_jax(arch, mesh, fsdp, pure_dp):
    m = MESHES[mesh]
    got = sharding.param_pspecs(get_model(ARCHS[arch]).param_defs(), m, fsdp, pure_dp)
    want = jsh.param_pspecs(jax_get_model(JAX_ARCHS[arch]).param_defs(), m, fsdp, pure_dp)
    assert _port_tree(got) == _jax_tree(want)


@pytest.mark.parametrize("mesh", ["single", "2x2"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b", "rwkv6-1.6b", "whisper-base"])
def test_cache_specs_equal_jax(arch, mesh):
    m = MESHES[mesh]
    caches = get_model(ARCHS[arch]).init_caches(8, 64, device="meta")
    jmodel = jax_get_model(JAX_ARCHS[arch])
    jcaches = jax.eval_shape(lambda: jmodel.init_caches(8, 64))
    got = _port_tree(sharding.cache_pspecs(caches, m))
    assert got == _jax_tree(jsh.cache_pspecs(jcaches, m))
    assert any(s != (None,) * len(s) for s in got.values())     # something shards


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base", "internvl2-2b"])
def test_batch_specs_equal_jax(arch, mesh):
    m = MESHES[mesh]
    cell = SHAPES["train_4k"]
    inputs = get_model(ARCHS[arch]).input_specs(cell)
    jinputs = jax_get_model(JAX_ARCHS[arch]).input_specs(cell)
    got = _port_tree(sharding.batch_pspecs(inputs, m))
    assert got == _jax_tree(jsh.batch_pspecs(jinputs, m))
    # batch 256 over (pod, data) on the multi-pod mesh, over data on one pod
    assert got["tokens"][0] == (("pod", "data") if mesh == "multi" else "data")


def test_rules_degrade_as_jax():
    m = MESHES["multi"]
    rules = sharding.make_rules(m, pure_dp=True)
    assert rules == jsh.make_rules(m, pure_dp=True)
    for shape in [(512, 4), (256, 4), (32, 4), (2, 4), (3, 4)]:
        assert sharding.resolve_axes(("batch", None), rules, shape, m) == \
            tuple(jsh.resolve_axes(("batch", None), rules, shape, m))
    # 256 on (pod, data, model) = 512 falls back to (pod, data) = 32
    assert sharding.resolve_axes(("batch",), rules, (256,), m) == (("pod", "data"),)
    assert sharding.data_axes(m) == jsh.data_axes(m) == ("pod", "data")


@pytest.mark.parametrize("spec,want", [
    ((None, None), (Replicate(), Replicate(), Replicate())),
    (("model", None), (Replicate(), Replicate(), Shard(0))),
    ((None, ("data", "model")), (Replicate(), Shard(1), Shard(1))),
    ((("pod", "data", "model"), None), (Shard(0), Shard(0), Shard(0))),
    ((("pod", "data"), "model"), (Shard(0), Shard(0), Shard(1))),
])
def test_placements(spec, want):
    assert sharding.placements(spec, MESHES["multi"]) == want


@pytest.mark.parametrize("spec,match", [
    ((("data", "pod"), None), "mesh order"),
    (("data", "data"), "named twice"),
    (("expert",), "no axis"),
])
def test_placements_refuse(spec, match):
    with pytest.raises(ValueError, match=match):
        sharding.placements(spec, MESHES["multi"])


def test_param_shardings_are_placements_of_the_specs():
    m = MESHES["single"]
    defs = get_model(ARCHS["llama3.2-1b"]).param_defs()
    specs = _port_tree(sharding.param_pspecs(defs, m, fsdp=True))
    shards = _port_tree(sharding.param_shardings(defs, m, fsdp=True))
    assert specs.keys() == shards.keys()
    for name, spec in specs.items():
        assert shards[name] == sharding.placements(spec, m)
    # wq (layers, w_embed, heads, head_dim): w_embed over data, heads over model
    assert shards["blocks.attn.wq"] == (Shard(1), Shard(2))


def test_logical_off_mesh_is_the_input_itself():
    x = torch.randn(2, 3, 4)
    assert not sharding.on_mesh()
    assert sharding.logical(x, "batch", "seq", "embed") is x
    assert sharding.gathered(x) is x
    with sharding.use_mesh(None):
        assert sharding.logical(x, "batch", None, "vocab") is x
        assert not sharding.on_mesh()


def test_use_mesh_binds_rules_and_restores():
    m = MESHES["single"]
    with sharding.use_mesh(m, fsdp=True):
        assert sharding.on_mesh()
        assert sharding._CTX.rules == jsh.make_rules(m, fsdp=True)
        with sharding.use_mesh(None):
            assert not sharding.on_mesh()
        assert sharding._CTX.mesh is m
    assert sharding._CTX.mesh is None and sharding._CTX.rules is None


def test_a_size_one_mesh_dim_replicates():
    m = types.SimpleNamespace(shape={"data": 4, "model": 1}, axis_names=("data", "model"))
    assert sharding.placements(("data", "model"), m) == (Shard(0), Replicate())
    assert sharding.placements((("data", "model"),), m) == (Shard(0), Replicate())
    one = types.SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model"))
    assert sharding.placements(("data", "model", None), one) == (Replicate(), Replicate())
