"""Every plan the JAX package builds for its own stencils, in the port.

The grid: the patterns the JAX package's benchmarks and examples name
(``benchmarks/fig10.py``, ``fig16.py``, ``table3.py``,
``examples/sweet_spot_explorer.py``) and Star-3D2R, at t = 1..8, in each
of the seven regimes: 504 cells.  Each builds on the CPU and matches the
JAX oracle within ``oracle_tolerance`` (the 3D cells whose regime's own
layout fits no tile in 232,448 bytes over a thread-block cluster; a cell
that no cluster of 8 CTAs held would raise "too deep" naming its regime,
``DEFERRED``, empty).  Sizes are small (2D 128^2, 3D 32^3, float32);
the oracle is JAX's ``apply_stencil`` stepped once per t from one jitted
step per pattern (``apply_stencil_steps``'s scan body; the test below
holds the two equal), cached per pattern.  Also: ``auto``'s decision at
full width against the JAX ``decide`` on the same geometry, the composed
bands 128 deep against the JAX ``build_bands_nd``, the taps the wide
tap-sums take, and the auditor's wide cells."""
import functools
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels.stencil_matmul import build_bands_nd as j_bands  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil, apply_stencil_steps  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import __main__ as sweep_cli  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.plan import auto_decision  # noqa: E402
from repro_torch.kernels.ref import oracle_tolerance  # noqa: E402
from repro_torch.stencil.spec import StencilSpec  # noqa: E402
from repro_torch.stencil.weights import fuse_weights  # noqa: E402
from test_torch_plan import J_H100  # noqa: E402

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

PATTERNS = ("Box-2D1R", "Box-2D3R", "Box-2D7R", "Star-2D1R", "Star-2D3R",
            "Box-3D1R", "Box-3D2R", "Star-3D1R", "Star-3D2R")
REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul")
DEPTHS = tuple(range(1, 9))
SHAPES = {2: (128, 128), 3: (32, 32, 32)}

#: The cells no tile holds, not even spread over a cluster of 8 CTAs
#: (the tile rule's third rung): none.  The 3D tap-sum's rings and the
#: composed slab past h = 10 and the reuse slabs past h = 14, which fit
#: no one CTA's 232,448 bytes, launch over a cluster.
DEFERRED = set()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The cells' plain versions are thousands of small tensor ops: one
    intra-op thread runs them as fast alone and does not oversubscribe the
    cores when several test processes share them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(pattern):
    """(weights, grid, oracle outputs at t = 1..8) of one pattern."""
    spec = JSpec.from_name(pattern)
    w = make_weights(spec, seed=0)
    x = np.random.default_rng(spec.dim).normal(
        size=SHAPES[spec.dim]).astype(np.float32)
    step = jax.jit(lambda z, w=jnp.asarray(w): apply_stencil(z, w))
    z, outs = jnp.asarray(x), []
    for _ in DEPTHS:
        z = step(z)
        outs.append(np.asarray(z))
    return w, x, outs


def test_the_stepped_oracle_is_apply_stencil_steps():
    w, x, outs = _case("Box-2D1R")
    np.testing.assert_array_equal(
        outs[-1], np.asarray(apply_stencil_steps(jnp.asarray(x),
                                                 jnp.asarray(w), 8)))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("t", DEPTHS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_cell_builds_and_matches_the_oracle(pattern, t, regime):
    w, x, outs = _case(pattern)
    build = functools.partial(tk.stencil_plan, w, x.shape, torch.float32, t,
                              backend=regime, device="cpu", use_cache=False)
    if (pattern, t, regime) in DEFERRED:
        with pytest.raises(ValueError, match=rf"too deep.*{regime}'s own "
                                             r"layout needs at least (\d+)"
                           ) as e:
            build()
        least = int(str(e.value).split("at least ")[1].split()[0])
        assert least > common.SMEM_BUDGET_BYTES
        return
    xt = torch.from_numpy(x)
    y = build()(xt)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(), outs[t - 1], rtol=0,
                               atol=oracle_tolerance(regime, t, w, xt))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_auto_decides_as_jax_on_the_same_geometry(pattern):
    # at full width (8192^2, 512^3), with and without the sparse unit
    spec = StencilSpec.from_name(pattern)
    shape = (8192, 8192) if spec.dim == 2 else (512, 512, 512)
    for t in DEPTHS:
        for sparse in (False, True):
            g, d = auto_decision(spec, shape, torch.float32, t,
                                 use_sparse_unit=sparse)
            geo = dict(strip_m=g.strip_m, h_block=g.h_block,
                       w_tile=g.w_tile, w_block=g.w_block)
            if spec.dim == 3:
                geo.update(z_slab=g.z_slab, z_block=g.z_block)
            jd = jplan.decide(JSpec(spec.shape, spec.dim, spec.radius), t, 4,
                              hw=J_H100, tile_n=16, use_sparse_unit=sparse,
                              **geo)
            assert (d.backend, d.scenario.name, d.reason) == \
                (jd.backend, jd.scenario.name, jd.reason)
            for k in d.candidates:
                assert d.candidates[k] == pytest.approx(jd.candidates[k],
                                                        rel=1e-12)


@pytest.mark.parametrize("pattern,t", [("Box-2D7R", 8), ("Box-2D7R", 4),
                                       ("Star-2D3R", 8)])
def test_auto_builds_where_its_regime_launches(pattern, t):
    w, x, outs = _case(pattern)
    xt = torch.from_numpy(x)
    plan = tk.stencil_plan(w, x.shape, torch.float32, t, device="cpu",
                           use_cache=False)
    np.testing.assert_allclose(plan(xt).numpy(), outs[t - 1], rtol=0,
                               atol=oracle_tolerance(plan.backend, t, w, xt))


@pytest.mark.parametrize("cdt,nk", [(torch.float32, 16), (torch.bfloat16, 8)])
def test_composed_bands_128_deep_are_jax_bands(cdt, nk):
    # Box-2D7R at t = 8: the composed radius-56 kernel's 113 bands of
    # (16 + 112, 16), as the JAX package builds them, and the Toeplitz
    # rows the 2D kernel reads, toe_ld = 128 + 16, every band nk k-steps
    w = make_weights(JSpec.from_name("Box-2D7R"), seed=0)
    wf = np.asarray(fuse_weights(w, 8), np.float32)
    offs, bands = t_matmul.build_bands_nd(wf, common.BAND_N)
    joffs, jb = j_bands(wf, common.BAND_N)
    assert list(offs) == list(joffs) and len(offs) == 113
    np.testing.assert_array_equal(bands, np.asarray(jb))
    assert bands.shape == (113, 128, 16)
    toe, rows = t_matmul._device_toe(wf.tobytes(), wf.shape, cdt, "cpu")
    assert tuple(toe.shape) == (113, 144)
    assert rows[:, 3].tolist() == [nk] * 113
    lay = common.tile_fold_layout(64, 64, 56, 1, cdt.itemsize, 113)
    assert (lay.kpad, lay.toe_ld) == (128, 144) and lay.kpad > t_matmul.MAX_KPAD
    # the dense 2D and 1D folds take it, the 3D fold and the compacted
    # fold keep MAX_KPAD
    t_matmul._checked(lay, "banded", deep=True)
    with pytest.raises(ValueError, match="contraction depth"):
        t_matmul._checked(lay, "3D banded")


@pytest.mark.parametrize("dim,r", [(2, 5), (2, 7), (3, 5), (3, 7)])
def test_wide_taps_are_the_dense_kernel(dim, r):
    # the host passes the (2r+1)^d taps row-major, the rest zero
    w = make_weights(JSpec("box", dim, r), seed=0).astype(np.float32)
    arg = t_direct._tap_arg(w.tobytes(), dim)
    cap = t_direct.MAX_TAPS if dim == 2 else t_direct.MAX_TAPS3D
    assert list(arg.w)[:w.size] == w.ravel().tolist()
    assert list(arg.w)[w.size:] == [0.0] * (cap - w.size)


@pytest.mark.parametrize("row", sweep_cli.WIDE_CELLS,
                         ids=lambda r: f"{r[0]}-t{r[1]}-{r[2]['shape']}"
                         f"{r[2]['radius']}-{r[3].get('boundary', '')}")
def test_wide_sweep_has_no_violations(row):
    reports, skipped = sweep_cli.sweep([row])
    assert all(r.ok for r in reports), "\n".join(
        r.summary() for r in reports if not r.ok)
    assert len([r for r in reports if r.exempt is None]) >= 5
    # refused: monolithic fusion under a boundary, the foils (which keep
    # the reserves' tiles, and whose whole tiles must cover the halo) past
    # them, and the 3D layouts past one CTA
    for s in skipped:
        foil = s["backend"].endswith("_wholestrip")
        assert ("monolithic" in s["reason"] or "too deep" in s["reason"]
                or foil and "exceeds" in s["reason"]), s
        assert "monolithic" in s["reason"] or foil or len(row[0]) == 3, s
