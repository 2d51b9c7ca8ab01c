"""The port's sharded train step (DTensor leaves under
``repro_torch.parallel.sharding.use_mesh``) against its single-device step,
on gloo worlds of 4 CPU ranks (``launch.world.run_world``).

JAX's own sharded-step test fails under jax 0.9.0 (a ``ShardingTypeError``),
so the port's sharded step is held to the port's single-device step, in
float32, from the same parameters (a seeded ``torch.Generator``) and batch
(numpy, seeded):

  * SMOKE llama3.2-1b on a 2x2 ("data", "model") mesh (here) and on 4x1
    (``test_torch_sharded_train41.py``): the loss
    within 1e-5 relative, every updated parameter within 1e-5 of its leaf's
    largest magnitude, every gradient within 1e-5 of its leaf's largest
    magnitude or twice the single-device gradient's own change under a
    one-ulp (2**-24 relative) perturbation of the parameters, whichever is
    larger.  The second term is there because JAX's init saturates the
    SMOKE models' attention (q and k scaled by the heads' fan-in), which
    amplifies f32 rounding about a thousandfold in the attention weights'
    gradients: a 1e-7 relative perturbation of the parameters moves
    ``blocks.attn.wk``'s gradient by 1.7e-4 of its largest magnitude, and
    the sharded step's reordered reductions are such a perturbation;
  * every other SMOKE arch on 2x2: the loss within 1e-5 relative;
  * checkpoints: an unsharded save restores onto the 2x2 mesh with its
    placements and the full tensors bit for bit, and a sharded save writes
    the full tensors;
  * two cached decode steps of SMOKE llama3.2-1b with its KV cache sharded
    along the sequence (the shard-local slot write) give the single-device
    logits within 1e-5 of their largest magnitude;
  * ``grad_compression="int8"`` under the mesh gives the single-device
    update within the same bound."""
import numpy as np
import pytest
import torch

import sharded_parity as sp
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.world import run_world
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.train import steps
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """An unsharded checkpoint of FULL's parameters at step 0."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    _, params, _ = sp.setup(sp.FULL)
    CheckpointManager(d).save(0, params)
    return d, params


@pytest.fixture(scope="module")
def world22(ckpt):
    return run_world(sp.sharded_rank, 4, args=(sp.ARCHS, ckpt[0], ("ckpt", "decode", "int8")),
                     mesh_shape=(2, 2), mesh_dim_names=("data", "model"),
                     device="cpu", timeout_s=400)[0]


def test_llama_sharded_step_matches_single_device(world22):
    sp.check_full(world22[sp.FULL], sp.single_reference(), "2x2")


@pytest.mark.parametrize("arch", [a for a in sp.ARCHS if a != sp.FULL])
def test_sharded_loss_matches_single_device(world22, arch):
    model, params, batch = sp.setup(arch)
    with torch.no_grad():
        loss = float(model.loss_fn(params, batch)[0])
    assert abs(world22[arch]["loss"] - loss) <= sp.TOL * abs(loss)


def test_unsharded_checkpoint_restores_onto_the_mesh(world22, ckpt):
    _, params = ckpt
    restored = dict(base.named_leaves(world22["restored"]))
    for name, want in base.named_leaves(params):
        assert np.array_equal(restored[name], want.numpy()), name
    assert world22["restored_placements"] == world22["placements"]


def test_sharded_save_writes_full_tensors(world22, ckpt):
    d, params = ckpt
    model = get_model(sp.cfg_of(sp.FULL))
    got = CheckpointManager(d).restore(1, model.param_shapes(), device="cpu")
    for (name, g), (_, w) in zip(base.named_leaves(got), base.named_leaves(params)):
        assert torch.equal(g, w), name


def test_sharded_decode_matches_single_device(world22):
    from torch.distributed.tensor import Shard

    model, params, _ = sp.setup(sp.FULL)
    for got, ref in zip(world22["decode"], sp.decode(model, params)):
        ref = ref.numpy()
        assert float(np.abs(got - ref).max()) <= sp.TOL * float(np.abs(ref).max())
    assert Shard(2) in world22["kv_placements"]     # kv_seq over `model`


def test_int8_compression_under_the_mesh(world22):
    model, params, batch = sp.setup(sp.FULL)
    _, _, new = sp.train_step(model, params, batch, "int8")
    sp.close_per_leaf(world22["int8"], sp.to_numpy(new), "int8 param")
