"""The port's GPipe pipeline (``repro_torch.parallel.pipeline``) against the
sequential layer stack and the JAX package's numbers, on a 2-rank gloo
world of CPU ranks.

JAX's case (``tests/test_pipeline.py``): L=4 layers of ``tanh(x @ w)``,
D=16, B=8 in M=4 microbatches, inputs from ``default_rng(0)``.  The
pipelined output equals the port's sequential stack within 1e-5 (every
rank gets it), and JAX's sequential stack within 1e-5; the schedule runs
M + S - 1 = 5 ticks with one ring shift each (JAX's collective-permute
count lies in 5..8); the bubble fraction of (2, 4) is 1/5."""
import numpy as np
import pytest
import torch

from repro_torch.launch.world import run_world
from repro_torch.parallel.pipeline import bubble_fraction, make_pipelined_step
from torch_threads import one_intra_op_thread  # noqa: F401

L, D, B, M = 4, 16, 8, 4


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L, D, D)).astype(np.float32) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return ws, x


def _layer(w, x):
    return torch.tanh(x @ w)


def _pipe_rank(mesh, rank):
    ws, x = _inputs()
    step = make_pipelined_step(_layer, L, mesh, axis="pod", microbatches=M)
    y = step(torch.from_numpy(ws), torch.from_numpy(x))
    return y.numpy(), dict(step.stats)


@pytest.fixture(scope="module")
def ranks():
    return run_world(_pipe_rank, 2, mesh_shape=(2,), mesh_dim_names=("pod",),
                     device="cpu", timeout_s=120)


def _sequential():
    ws, x = _inputs()
    ref = torch.from_numpy(x)
    for i in range(L):
        ref = _layer(torch.from_numpy(ws[i]), ref)
    return ref.numpy()


def test_matches_the_sequential_stack_on_every_rank(ranks):
    ref = _sequential()
    for y, _ in ranks:
        assert float(np.abs(y - ref).max()) < 1e-5


def test_matches_jax_sequential():
    jnp = pytest.importorskip("jax.numpy")
    ws, x = _inputs()
    ref = jnp.asarray(x)
    for i in range(L):
        ref = jnp.tanh(ref @ jnp.asarray(ws[i]))
    assert float(np.abs(_sequential() - np.asarray(ref)).max()) < 1e-5


def test_ticks_and_ring_shifts(ranks):
    for _, stats in ranks:
        assert stats["calls"] == 1 and stats["ticks"] == M + 2 - 1
        assert 5 <= stats["p2p_ops"] <= 8            # JAX's collective-permutes
        assert stats["bytes_sent"] == stats["p2p_ops"] * (B // M) * D * 4
    assert abs(bubble_fraction(2, 4) - 1 / 5) < 1e-9


def _single_rank(mesh, rank):
    ws, x = _inputs()
    step = make_pipelined_step(_layer, L, mesh, axis="pod", microbatches=M)
    return step(torch.from_numpy(ws), torch.from_numpy(x)).numpy(), dict(step.stats)


def test_one_stage_is_the_stack_without_p2p():
    (y, stats), = run_world(_single_rank, 1, mesh_shape=(1,), mesh_dim_names=("pod",),
                            device="cpu", timeout_s=120)
    assert np.array_equal(y, _sequential_microbatched())
    assert stats["p2p_ops"] == 0 and stats["ticks"] == M


def _sequential_microbatched():
    """The stack run on each microbatch on its own (the pipeline's shapes)."""
    ws, x = _inputs()
    out = []
    for mb in np.split(x, M):
        h = torch.from_numpy(mb)
        for i in range(L):
            h = _layer(torch.from_numpy(ws[i]), h)
        out.append(h.numpy())
    return np.concatenate(out)


def test_refusals():
    mesh = type("Mesh", (), {"mesh_dim_names": ("pod",), "size": lambda self, i: 3,
                             "get_local_rank": lambda self, i: 0,
                             "get_group": lambda self, i: None})()
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        make_pipelined_step(_layer, 4, mesh)
    with pytest.raises(ValueError, match="no dim named"):
        make_pipelined_step(_layer, 3, mesh, axis="data")
