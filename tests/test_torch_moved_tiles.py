"""The 2D cells whose tiles the rule moved when it took the 2D kernels'
own layouts (h = 17..34: Box-2D7R t = 3 and 4, Box-2D3R t = 8, Star-2D3R
t = 7), on the CPU at 160 x 200: every fused regime and ``auto`` builds
on the 64 x 64 tile its own layout fits (the 2D reserve took 32 x 32 or
16 x 16 there), matches JAX's oracle (``apply_stencil`` stepped t times)
within ``oracle_tolerance``, and ``auto`` decides as JAX's ``decide`` on
the same geometry, with and without the sparse unit.  The kernels on
those tiles are emulated in tests/test_torch_tapsum2d_fold.py and run on
the card in ``chip_smoke.py --wide``."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import plan as jplan  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil_steps  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.plan import auto_decision  # noqa: E402
from repro_torch.kernels.ref import oracle_tolerance  # noqa: E402
from repro_torch.stencil.spec import StencilSpec  # noqa: E402
from test_torch_plan import J_H100  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

SHAPE = (160, 200)
CELLS = [("Box-2D7R", 3), ("Box-2D7R", 4), ("Box-2D3R", 8), ("Star-2D3R", 7)]
REGIMES = ("fused_direct", "fused_matmul", "fused_matmul_reuse",
           "fused_sparse_matmul", None)
#: The plan entries the regimes launch through, as the registry calls them.
ENTRIES = ("stencil_direct_at", "stencil_matmul_at", "stencil_sparse_matmul_at")


@functools.lru_cache(maxsize=None)
def _case(pattern, t):
    """(weights, grid, JAX's oracle after t steps) of one cell."""
    w = np.asarray(make_weights(JSpec.from_name(pattern), seed=0), np.float32)
    x = np.random.default_rng(t).normal(size=SHAPE).astype(np.float32)
    y = apply_stencil_steps(jnp.asarray(x), jnp.asarray(w), t)
    return w, x, np.asarray(y)


@pytest.fixture
def launched(monkeypatch):
    """The tiles the plans' launches take, (strip_m, w_tile) in call order,
    read at the registry's plan entries."""
    seen = []
    for name in ENTRIES:
        entry = getattr(registry, name)

        def at(x, w, t, geom, *args, entry=entry, **kw):
            seen.append((geom.strip_m, geom.w_tile))
            return entry(x, w, t, geom, *args, **kw)
        monkeypatch.setattr(registry, name, at)
    return seen


@pytest.mark.parametrize("regime", REGIMES, ids=lambda r: r or "auto")
@pytest.mark.parametrize("pattern,t", CELLS)
def test_moved_cell_builds_on_64x64_and_matches_the_oracle(pattern, t, regime,
                                                           launched):
    w, x, ref = _case(pattern, t)
    plan = tk.stencil_plan(w, SHAPE, torch.float32, t, backend=regime,
                           device="cpu", use_cache=False)
    y = plan(torch.from_numpy(x))
    assert launched == [(64, 64)]
    assert (plan.geom.strip_m, plan.geom.w_tile) == (64, 64)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=oracle_tolerance(
        plan.backend, t, w, torch.from_numpy(x)))


@pytest.mark.parametrize("pattern,t", CELLS)
def test_moved_cell_decides_as_jax_on_the_same_geometry(pattern, t):
    spec = StencilSpec.from_name(pattern)
    for shape in (SHAPE, (8192, 8192)):
        for sparse in (False, True):
            g, d = auto_decision(spec, shape, torch.float32, t,
                                 use_sparse_unit=sparse)
            assert (g.strip_m, g.w_tile) == (64, 64)
            jd = jplan.decide(JSpec(spec.shape, spec.dim, spec.radius), t, 4,
                              hw=J_H100, tile_n=16, use_sparse_unit=sparse,
                              strip_m=g.strip_m, h_block=g.h_block,
                              w_tile=g.w_tile, w_block=g.w_block)
            assert (d.backend, d.scenario.name, d.reason) == \
                (jd.backend, jd.scenario.name, jd.reason)
            for k in d.candidates:
                assert d.candidates[k] == pytest.approx(jd.candidates[k],
                                                        rel=1e-12)
