"""Every deep 3D plan the JAX package builds, the port builds: the sweep
of {Box, Star}-3D{3..7}R x t = 1..8 x the seven regimes and ``auto`` on
64^3, and Box-2D7R past one CTA (t = 16, 24, 29 on 1024^2, h = 112 to
203), each built by both packages' ``stencil_plan`` (the port on the CPU,
its fused launches past any CTA and cluster on the tile rule's fourth
rung).  The radii 1-2 are in ``tests/test_torch_wide.py``; the numbers on
a sample of the deep 3D cells in ``tests/test_torch_workspace_deep*.py``.

Composing a kernel t times (``fuse_weights``: the composed contraction's
operand, built when the plan is) takes minutes at Box-3D7R t = 8 on this
CPU in either package, and whether a plan builds depends on the composed
kernel's shape and nonzero x-rows only.  So the sweep builds
``fused_matmul`` with a stand-in for ``fuse_weights`` in both packages:
the composed support as ones (every offset t steps of the stencil reach),
held here to the real composition's support where that is cheap.  Both
packages also count a star's fused support through
``repro_torch.stencil.weights.fused_num_points``, which equals JAX's
composed masks (``tests/test_torch_host.py``) in microseconds.

The 2D cells past one CTA (Box-2D7R ``fused_direct`` and
``fused_matmul_reuse`` at t = 16 and 29) also match JAX's oracle (its
``apply_stencil``, jitted once, stepped t times) within
``oracle_tolerance`` on the smallest grid both packages take (the halo)."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.registry as jregistry  # noqa: E402
import repro.stencil.weights as jweights  # noqa: E402
from repro.kernels import stencil_plan as j_plan  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
import repro_torch.kernels.registry as tregistry  # noqa: E402
from repro_torch.kernels.ref import oracle_tolerance  # noqa: E402
from repro_torch.stencil import weights as tweights  # noqa: E402

REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul",
           None)
PATTERNS = tuple(f"{s}-3D{r}R" for s in ("Box", "Star") for r in range(3, 8))
DEPTHS = tuple(range(1, 9))
SHAPE = (64, 64, 64)


def composed_support(w, t: int) -> np.ndarray:
    """The support of ``w`` composed ``t`` times, as ones: every offset
    reachable in t steps of the stencil (a box's: the box of radius t r; a
    star's: offsets whose axes need ceil(|a_i| / r) steps, summing to at
    most t)."""
    w = np.asarray(w)
    r = (w.shape[0] - 1) // 2
    if np.count_nonzero(w) == w.size:
        return np.ones((2 * t * r + 1,) * w.ndim, w.dtype)
    idx = np.indices((2 * t * r + 1,) * w.ndim) - t * r
    return (sum(-(-np.abs(a) // r) for a in idx) <= t).astype(w.dtype)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions here are thousands of small tensor ops: one
    intra-op thread runs them as fast alone and does not oversubscribe the
    cores when several test processes share them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quick_composition():
    """Both packages' plans compose with ``composed_support``, and JAX's
    decision counts a star's fused support with the port's closed count."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jregistry, "fuse_weights", composed_support)
    mp.setattr(tregistry, "fuse_weights", composed_support)
    mp.setattr(jweights, "fused_num_points", tweights.fused_num_points)
    yield
    mp.undo()


@pytest.mark.parametrize("pattern,t", [("Box-3D3R", 3), ("Star-3D3R", 3),
                                       ("Star-3D4R", 2), ("Box-2D7R", 3),
                                       ("Star-3D7R", 2)])
def test_the_stand_in_is_the_composed_support(pattern, t):
    w = make_weights(JSpec.from_name(pattern), seed=0)
    support = composed_support(w, t)
    for fuse in (jweights.fuse_weights, tweights.fuse_weights):
        np.testing.assert_array_equal(fuse(w, t) != 0, support != 0)


def _outcome(build):
    try:
        build()
        return "builds"
    except ValueError as e:
        return f"raises: {e}"


@pytest.mark.parametrize("pattern", PATTERNS)
def test_the_port_builds_where_jax_builds(pattern, quick_composition):
    w = make_weights(JSpec.from_name(pattern), seed=0)
    differ, refused = [], []
    for t in DEPTHS:
        for regime in REGIMES:
            jax_says = _outcome(lambda: j_plan(w, SHAPE, jnp.float32, t,
                                               backend=regime))
            port_says = _outcome(lambda: tk.stencil_plan(
                w, SHAPE, torch.float32, t, backend=regime, device="cpu",
                use_cache=False))
            if (jax_says == "builds") != (port_says == "builds"):
                differ.append((t, regime, jax_says, port_says))
            if "too deep" in port_says:
                refused.append((t, regime, port_says))
    assert not differ, differ
    assert not refused, refused


#: Box-2D7R past one CTA on 1024^2: the depths and the regimes both
#: packages build there.
DEEP_2D = (16, 24, 29)


def test_box_2d7r_past_one_cta_builds_where_jax_builds(quick_composition):
    w = make_weights(JSpec.from_name("Box-2D7R"), seed=0)
    shape = (1024, 1024)
    for t in DEEP_2D:
        for regime in REGIMES:
            jax_says = _outcome(lambda: j_plan(w, shape, jnp.float32, t,
                                               backend=regime))
            plan = None

            def build():
                nonlocal plan
                plan = tk.stencil_plan(w, shape, torch.float32, t,
                                       backend=regime, device="cpu",
                                       use_cache=False)
            port_says = _outcome(build)
            assert (jax_says == "builds") == (port_says == "builds"), \
                (t, regime, jax_says, port_says)
            assert "too deep" not in port_says, (t, regime, port_says)
            if regime in ("fused_direct", "fused_matmul_reuse"):
                assert plan.fn.workspace is not None, (t, regime)


@functools.lru_cache(maxsize=None)
def _oracle_2d(n: int, t: int):
    """JAX's apply_stencil of Box-2D7R, jitted once, stepped t times from
    one n x n grid: (weights, grid, output)."""
    w = make_weights(JSpec.from_name("Box-2D7R"), seed=0)
    x = np.random.default_rng(2).normal(size=(n, n)).astype(np.float32)
    step = jax.jit(lambda z, w=jnp.asarray(w): apply_stencil(z, w))
    z = jnp.asarray(x)
    for _ in range(t):
        z = step(z)
    return w, x, np.asarray(z)


@pytest.mark.parametrize("t", [16, 29])
@pytest.mark.parametrize("regime", ["fused_direct", "fused_matmul_reuse"])
def test_box_2d7r_past_one_cta_matches_the_oracle(regime, t):
    # on the smallest grid both packages take: as deep as the halo
    n = 7 * t
    for size in (n - 1, n):
        says = [_outcome(lambda: j_plan(np.ones((15, 15), np.float32),
                                        (size, size), jnp.float32, t,
                                        backend=regime)),
                _outcome(lambda: tk.stencil_plan(
                    np.ones((15, 15), np.float32), (size, size),
                    torch.float32, t, backend=regime, device="cpu",
                    use_cache=False))]
        assert all(s == "builds" for s in says) == (size == n), (size, says)
    w, x, want = _oracle_2d(n, t)
    plan = tk.stencil_plan(w, (n, n), torch.float32, t, backend=regime,
                           device="cpu", use_cache=False)
    assert plan.fn.workspace is not None
    xt = torch.from_numpy(x)
    y = plan(xt)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=oracle_tolerance(regime, t, w, xt))
