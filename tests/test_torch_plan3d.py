"""The slice on 3D and 1D grids against the JAX package: the port's
``stencil_plan(..., device="cpu")(x)`` for every regime, ``auto`` and
``reference`` against the JAX oracle (and, on a few cases, against the JAX
plan itself in interpret mode), the port's decisions against the JAX
``decide`` on the same workloads and geometry, and ``explain``."""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels.ref import stencil_direct_ref as j_ref  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402

from test_torch_plan import J_H100, tolerance  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

BACKENDS = ["direct", "fused_direct", "matmul", "fused_matmul",
            "fused_matmul_reuse", None, "reference"]     # None = auto
SHAPES_3D = [(8, 16, 32), (6, 20, 37)]


def _inputs(kind, dim, r, t, shape):
    w = make_weights(JSpec(kind, dim, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    return w, x


@functools.lru_cache(maxsize=None)
def _oracle(kind, dim, r, t, shape):
    """The JAX oracle of one case, computed once for all backends."""
    w, x = _inputs(kind, dim, r, t, shape)
    return np.asarray(j_ref(jnp.asarray(x), w, t))


def check_decision(plan, t, dtype_bytes):
    """The port's decision equals the JAX ``decide`` asked the same
    question: the H100 data-sheet spec and the port's tile as the JAX
    geometry arguments."""
    g, dim = plan.geom, plan.spec.dim
    geo = {}
    if dim >= 2:
        geo = dict(strip_m=g.strip_m, h_block=g.h_block, w_tile=g.w_tile,
                   w_block=g.w_block)
        assert (g.h_block, g.w_block) == (t * plan.spec.radius,) * 2
    if dim == 3:
        geo.update(z_slab=g.z_slab, z_block=g.z_block)
        assert g.z_block == t * plan.spec.radius
    jd = jplan.decide(JSpec(plan.spec.shape, dim, plan.spec.radius), t,
                      dtype_bytes, hw=J_H100, tile_n=16, **geo)
    d = plan.decision
    assert (d.backend, d.scenario.name, d.reason) == \
        (jd.backend, jd.scenario.name, jd.reason)
    assert d.candidates.keys() == jd.candidates.keys()
    for k in d.candidates:
        assert d.candidates[k] == pytest.approx(jd.candidates[k], rel=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 2])
def test_3d_plan_matches_jax(backend, shape, kind, r, t):
    w, x = _inputs(kind, 3, r, t, shape)
    plan = tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                           device="cpu")
    port = plan(torch.from_numpy(x))
    assert port.dtype == torch.float32 and tuple(port.shape) == shape
    np.testing.assert_allclose(port.numpy(), _oracle(kind, 3, r, t, shape),
                               rtol=0, atol=tolerance(x, torch.float32, t, 1))
    assert plan.geom.dim == 3
    check_decision(plan, t, 4)


@pytest.mark.parametrize("backend", ["direct", "fused_direct", "matmul",
                                     "fused_matmul", "fused_matmul_reuse"])
def test_3d_plan_matches_the_jax_plan(backend):
    # the JAX plan itself, on its slab substrate in interpret mode, on a
    # grid no tile divides
    shape, t = (6, 20, 37), 2
    w, x = _inputs("box", 3, 1, t, shape)
    port = tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                           device="cpu")(torch.from_numpy(x))
    jp = jplan.stencil_plan(w, shape, jnp.float32, t, backend=backend)
    np.testing.assert_allclose(port.numpy(), np.asarray(jp(jnp.asarray(x))),
                               rtol=0, atol=tolerance(x, torch.float32, t, 1))


def test_3d_plan_bf16_matches_jax():
    shape, t = (6, 20, 37), 2
    w, x = _inputs("star", 3, 1, t, shape)
    ref = _oracle("star", 3, 1, t, shape)
    for backend in ("fused_direct", "fused_matmul_reuse"):
        plan = tk.stencil_plan(w, shape, torch.bfloat16, t, backend=backend,
                               device="cpu")
        port = plan(torch.from_numpy(x).to(torch.bfloat16))
        assert port.dtype == torch.bfloat16
        # bf16 input rounding, then one rounding per step and the output
        np.testing.assert_allclose(
            port.float().numpy(), ref, rtol=0,
            atol=tolerance(x, torch.bfloat16, t, t + 2))
        check_decision(plan, t, 2)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [64, 67])
@pytest.mark.parametrize("kind,r", [("box", 1), ("star", 3)])
def test_1d_plan_matches_the_jax_plan(backend, n, kind, r):
    t = 2
    w, x = _inputs(kind, 1, r, t, (n,))
    plan = tk.stencil_plan(w, (n,), torch.float32, t, backend=backend,
                           device="cpu")
    port = plan(torch.from_numpy(x))
    assert tuple(port.shape) == (n,)
    jp = jplan.stencil_plan(w, (n,), jnp.float32, t, backend=backend)
    np.testing.assert_allclose(port.numpy(), np.asarray(jp(jnp.asarray(x))),
                               rtol=0, atol=tolerance(x, torch.float32, t, 1))
    assert plan.geom.dim == 1 and "1D lifted" in plan.decision.reason
    check_decision(plan, t, 4)


#: 3D plans whose tiles the reserves admit, h = t*r <= 9 (the deeper
#: halos run on the tiles of their own layouts: tests/test_torch_wide.py).
DECISION_CASES = [(dim, shape, kind, r, t)
                  for dim, shape in ((3, (512, 512, 512)), (3, (60, 70, 130)),
                                     (1, (2**26,)), (1, (67,)))
                  for kind in ("box", "star") for r in (1, 2, 3)
                  for t in (1, 2, 4) if dim == 1 or r * t <= 9]


@pytest.mark.parametrize("dim,shape,kind,r,t", DECISION_CASES)
def test_decision_parity(dim, shape, kind, r, t):
    w = make_weights(JSpec(kind, dim, r), seed=0)
    for dtype, nbytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        plan = tk.stencil_plan(w, shape, dtype, t, device="cpu",
                               use_cache=False)
        check_decision(plan, t, nbytes)
        assert tk.explain(w, t, nbytes, grid_shape=shape) == plan.decision


def test_main_path_decisions():
    # Box/Star-3D1R at t=4 on 512^3: the tile the plan prices
    for kind in ("box", "star"):
        w = make_weights(JSpec(kind, 3, 1), seed=0)
        plan = tk.stencil_plan(w, (512, 512, 512), torch.float32, 4,
                               device="cpu", use_cache=False)
        assert "read_amp=2.812x (z_slab=16, z_block=4, strip_m=16" \
            in plan.decision.reason
        assert plan.backend == plan.decision.backend


# ---------------------------------------------------------------------------
# The z_slab pin (the JAX plan's ``z_slab``, plan.py:415): the 3D tile's
# depth, in the cache key, checked when the plan is built.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["fused_direct", "direct", "matmul",
                                     "fused_matmul_reuse"])
@pytest.mark.parametrize("z_slab,want", [(4, 4), (2, 2), (64, 20)])
def test_z_slab_pin_reaches_the_tile_and_explain(backend, z_slab, want):
    w, x = _inputs("box", 3, 1, 2, (20, 24, 40))
    plan = tk.stencil_plan(w, x.shape, torch.float32, 2, backend=backend,
                           z_slab=z_slab, device="cpu")
    assert plan.geom.z_slab == want                 # priced (halo t*r)
    inner = 1 if backend in ("direct", "matmul") else 2
    assert plan.ctx.launch_geom(w, inner).z_slab == want  # launched
    assert f"z_slab={want}," in plan.explain()
    free = tk.stencil_plan(w, x.shape, torch.float32, 2, backend=backend,
                           device="cpu")
    assert free.key != plan.key and free.geom.z_slab == 16
    xt = torch.from_numpy(x)
    assert torch.equal(plan(xt), free(xt))          # the tile is not math


def test_z_slab_pin_the_jax_decision():
    # the pinned tile prices as the JAX decide prices it
    w, _ = _inputs("star", 3, 1, 2, (20, 24, 40))
    plan = tk.stencil_plan(w, (20, 24, 40), torch.float32, 2, z_slab=4,
                           device="cpu")
    g = plan.geom
    jd = jplan.decide(JSpec("star", 3, 1), 2, 4, hw=J_H100, tile_n=16,
                      strip_m=g.strip_m, h_block=g.h_block, z_slab=4,
                      z_block=g.z_block, w_tile=g.w_tile, w_block=g.w_block)
    assert plan.decision.reason == jd.reason


def test_z_slab_pin_refusals():
    w3, _ = _inputs("box", 3, 1, 1, (20, 24, 40))
    w2 = make_weights(JSpec("box", 2, 1), seed=0)
    with pytest.raises(ValueError, match="3D tile"):
        tk.stencil_plan(w2, (32, 32), torch.float32, 1, z_slab=4,
                        device="cpu")
    with pytest.raises(ValueError, match="z_slab must be >= 1"):
        tk.stencil_plan(w3, (20, 24, 40), torch.float32, 1, z_slab=0,
                        device="cpu")
    # a 16-deep tile at halo 8 is past every reserve but the regime's own
    # layout fits it; at halo 12 the reuse fold's slab fits it only over a
    # thread-block cluster, and at halo 40 over no cluster of 8 CTAs: the
    # fourth rung, the slab in a device workspace on the pinned depth
    plan = tk.stencil_plan(w3, (20, 24, 40), torch.float32, 8, z_slab=16,
                           device="cpu", use_cache=False)
    assert plan.geom.z_slab == 16
    x3 = _inputs("box", 3, 1, 1, (20, 24, 40))[1]
    np.testing.assert_allclose(
        plan(torch.from_numpy(x3)).numpy(),
        np.asarray(j_ref(jnp.asarray(x3), w3, 8)), rtol=0,
        atol=8e-5 * np.abs(x3).max())
    p12 = tk.stencil_plan(w3, (20, 24, 40), torch.float32, 12, z_slab=16,
                          backend="fused_matmul_reuse", device="cpu",
                          use_cache=False)
    assert p12.geom.z_slab == 16
    p40 = tk.stencil_plan(w3, (20, 24, 40), torch.float32, 40, z_slab=16,
                          backend="fused_matmul_reuse", device="cpu",
                          use_cache=False)
    assert p40.fn.workspace is not None
    assert p40.fn.workspace.base.planes == 16 + 2 * 40
    # shallower than the halo under the whole-slab foil (JAX's message)
    with pytest.raises(ValueError, match="exceeds z_slab 2"):
        tk.stencil_plan(w3, (20, 24, 40), torch.float32, 4, z_slab=2,
                        backend="fused_direct_wholestrip", device="cpu")
