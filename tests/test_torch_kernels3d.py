"""The kernel modules on 3D and 1D grids against the JAX package: the
tap-sum and banded contraction (through their plain versions, which is
what a CPU tensor runs) against the JAX ``stencil_direct`` /
``stencil_matmul`` in interpret mode, the 3D tile geometry as pure Python,
the 1D lift, and the argument rule shared by both packages."""
import functools
import importlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.ref import stencil_direct_ref as j_ref  # noqa: E402
from repro.kernels.stencil_direct import stencil_direct as j_direct  # noqa
from repro.kernels.stencil_matmul import band_sparsity as j_band_sparsity  # noqa
from repro.kernels.stencil_matmul import stencil_matmul as j_matmul  # noqa
from repro.stencil import StencilSpec, fuse_weights, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import scratch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")


def _grid(shape, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def tolerance(x: np.ndarray, dtype, t: int) -> float:
    """As tests/test_torch_kernels*.py: f32, 1e-5 * max|x| per step (the
    two frameworks form FMAs differently); bf16, two bf16 ulps of max|x|
    per rounding (one per step for the banded operands)."""
    mx = float(np.abs(x).max())
    if dtype == torch.bfloat16:
        return t * 2 * 2.0**-8 * mx
    return 1e-5 * mx * t


# Interpret-mode 3D Pallas takes about a second a call: few cases.
CASES_3D = [((8, 16, 32), "box", 1, 2), ((6, 20, 37), "star", 2, 1),
            ((6, 20, 37), "box", 1, 2)]
CASES_1D = [(n, kind, r, t) for n in (64, 67) for kind, r in
            (("box", 1), ("star", 3)) for t in (1, 2)]


@pytest.mark.parametrize("shape,kind,r,t", CASES_3D + CASES_1D)
def test_direct_plain_matches_jax(shape, kind, r, t):
    shape = shape if isinstance(shape, tuple) else (shape,)
    w = make_weights(StencilSpec(kind, len(shape), r), seed=r + t)
    x, xt, xj = _grid(shape, seed=t)
    port = t_direct.stencil_direct(xt, w, t)          # CPU -> plain version
    assert port.dtype == torch.float32 and tuple(port.shape) == shape
    ref = np.asarray(j_direct(xj, w, t, interpret=True))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tolerance(x, torch.float32, t))


@pytest.mark.parametrize("shape,kind,r,t", CASES_3D + CASES_1D)
def test_banded_plain_matches_jax(shape, kind, r, t):
    shape = shape if isinstance(shape, tuple) else (shape,)
    w = make_weights(StencilSpec(kind, len(shape), r), seed=r + t)
    x, xt, xj = _grid(shape, seed=t)
    port = t_matmul.stencil_matmul(xt, w, t)
    ref = np.asarray(j_matmul(xj, w, t, interpret=True))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tolerance(x, torch.float32, t))


@pytest.mark.parametrize("shape", [(6, 20, 37), (67,)])
def test_banded_plain_monolithic_fusion_matches_jax(shape):
    w = fuse_weights(make_weights(StencilSpec("box", len(shape), 1),
                                  seed=4), 2)
    x, xt, xj = _grid(shape)
    port = t_matmul.stencil_matmul(xt, w, 1)
    ref = np.asarray(j_matmul(xj, w, 1, interpret=True))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tolerance(x, torch.float32, 2))


def test_plain_bf16_3d_matches_jax():
    w = make_weights(StencilSpec("star", 3, 1), seed=0)
    x, xt, xj = _grid((6, 20, 37), torch.bfloat16)
    for port, ref in ((t_direct.stencil_direct(xt, w, 2),
                       j_direct(xj, w, 2, interpret=True)),
                      (t_matmul.stencil_matmul(xt, w, 2),
                       j_matmul(xj, w, 2, interpret=True))):
        assert port.dtype == torch.bfloat16
        np.testing.assert_allclose(
            port.float().numpy(), np.asarray(ref).astype(np.float32),
            rtol=0, atol=tolerance(x, torch.bfloat16, 2))


@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_plain_3d_against_the_jax_oracle(kind, r):
    # the whole (2r+1)^3 range of radii the 3D tap-sum kernel takes
    w = make_weights(StencilSpec(kind, 3, r), seed=r)
    x, xt, xj = _grid((7, 9, 11), seed=r)
    ref = np.asarray(j_ref(xj, w, 1))
    for port in (t_direct.stencil_direct(xt, w, 1),
                 t_matmul.stencil_matmul(xt, w, 1)):
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=tolerance(x, torch.float32, 1))


def test_nonzero_taps_3d_row_major():
    w = make_weights(StencilSpec("star", 3, 1), seed=0)
    taps = t_direct.nonzero_taps(w)
    assert [tap[:3] for tap in taps] == [(0, 1, 1), (1, 0, 1), (1, 1, 0),
                                         (1, 1, 1), (1, 1, 2), (1, 2, 1),
                                         (2, 1, 1)]


@pytest.mark.parametrize("kind,r,t", [("box", 1, 4), ("star", 1, 4),
                                      ("box", 2, 4), ("star", 2, 1)])
def test_band_sparsity_3d(kind, r, t):
    w = fuse_weights(make_weights(StencilSpec(kind, 3, r), seed=0), t)
    s = t_matmul.band_sparsity(w, 16)
    assert s == j_band_sparsity(w, 16)
    offsets, bands = t_matmul.build_bands_nd(w.astype(np.float32), 16)
    assert s == pytest.approx(np.count_nonzero(bands) / bands.size)
    if kind == "box":          # every (dz, dy) row of a box is a band
        assert len(offsets) == (2 * r * t + 1) ** 2


# ---------------------------------------------------------------------------
# The 1D lift
# ---------------------------------------------------------------------------
def test_lift_weights_is_the_middle_row():
    w = make_weights(StencilSpec("box", 1, 3), seed=0)
    w2 = common.lift_weights(w)
    assert w2.shape == (7, 7) and np.array_equal(w2[3], w)
    assert np.count_nonzero(w2) == np.count_nonzero(w)
    offsets, _ = t_matmul.build_bands_nd(w2, 16)
    assert offsets == [(3,)]                 # one band: the real row


@pytest.mark.parametrize("r,t", [(1, 1), (3, 2)])
def test_lift_computes_the_1d_stencil(r, t):
    # the 2D functions on the (1, N) view with the lifted kernel are the
    # 1D stencil: what the kernels run on the card
    w = make_weights(StencilSpec("star", 1, r), seed=0)
    _, xt, _ = _grid((67,))
    w2 = common.lift_weights(w)
    one_d = t_direct.stencil_direct_plain(xt, w, t)
    torch.testing.assert_close(
        t_direct.stencil_direct_plain(xt.view(1, -1), w2, t).view(-1), one_d,
        rtol=0, atol=0)
    torch.testing.assert_close(
        t_matmul.stencil_matmul_plain(xt.view(1, -1), w2, t).view(-1),
        t_matmul.stencil_matmul_plain(xt, w, t), rtol=0, atol=0)


@pytest.mark.parametrize("n,halo", [(64, 1), (67, 12), (2**20 + 3, 4)])
def test_lifted_tile_covers_the_row(n, halo):
    g = common.lifted_tile_geom(n, halo)
    assert (g.dim, g.strip_m, g.h_block) == (2, 16, halo)
    gx, gy = common.launch_grid((1, n), g)
    assert gy == 1 and gx == -(-n // g.w_tile)
    if n < 10**4:
        hits = np.zeros(n, dtype=int)
        for (r0, r1), (c0, c1), _, (p0, p1) in common.tile_windows((1, n), g):
            assert (r0, r1) == (0, 1)
            hits[c0:c1] += 1
            assert (p0, p1) == (c0 - halo, c0 + g.w_tile + halo)
        assert (hits == 1).all()
    priced = common.resolve_tile_geom((n,), halo)
    assert (priced.dim, priced.strip_m, priced.read_amp) == (1, 1, 1.0)


# ---------------------------------------------------------------------------
# 3D tile geometry (pure Python): what the kernels launch and read.
# ---------------------------------------------------------------------------
GEOM_3D = [((8, 16, 32), 2), ((6, 20, 37), 4), ((60, 70, 130), 3),
           ((128, 128, 128), 4), ((512, 512, 512), 4), ((512, 512, 512), 8),
           ((512, 512, 512), 1), ((3, 5, 7), 9)]


@pytest.mark.parametrize("grid_shape,halo", GEOM_3D)
def test_3d_tiles_cover_grid_once_and_reads_cover_halo(grid_shape, halo):
    g = common.resolve_tile_geom(grid_shape, halo)
    assert g.dim == 3 and g.strip_m % 16 == 0 and g.w_tile % 16 == 0
    assert (g.z_block, g.h_block, g.w_block) == (halo, halo, halo)
    assert g.read_amp == pytest.approx((1 + 2 * halo / g.z_slab)
                                       * (1 + 2 * halo / g.strip_m)
                                       * (1 + 2 * halo / g.w_tile))
    if np.prod(grid_shape) > 10**6:      # sizing only
        return
    hits = np.zeros(grid_shape, dtype=int)
    tile = (g.z_slab, g.strip_m, g.w_tile)
    for win in common.tile_windows(grid_shape, g):
        outs, reads = win[:3], win[3:]
        hits[tuple(slice(a, b) for a, b in outs)] += 1
        for (a, _), (q0, q1), size in zip(outs, reads, tile):
            assert (q0, q1) == (a - halo, a + size + halo)
    assert (hits == 1).all()


@pytest.mark.parametrize("grid_shape,halo", GEOM_3D)
def test_3d_kernel_layouts_fit_under_the_sizing_bound(grid_shape, halo):
    g = common.resolve_tile_geom(grid_shape, halo)
    tz, tm, tn = g.z_slab, g.strip_m, g.w_tile
    bound = common.tile_smem_bound(tm, tn, halo, tz)
    assert bound <= common.SMEM_BUDGET_BYTES
    assert common.direct3d_reserve(tz, tm, tn, halo) <= bound
    for t in range(1, halo + 1):
        if halo % t:
            continue
        r = halo // t
        if r <= 3:              # the tap-sum's rings, one per step but the last
            d = common.direct3d_layout(tm, tn, r, t)
            assert d.smem_bytes <= bound and d.rows == tm + 2 * halo
            assert d.slots == (2 * r + 1 + common.DIRECT3D_AHEAD) + (t - 1) * (2 * r + 2)
            checks = scratch.audit_layout("tapsum3d", g, r, t, d)
            assert all(c.passed for c in checks), [c.to_dict() for c in checks]
        for cb in (4, 2):       # the slab fold's layout, (2r+1)^2 bands
            b = common.slab_fold_layout(tz, tm, tn, r, t, cb,
                                        (2 * r + 1) ** 2)
            assert b.smem_bytes <= bound and b.planes == tz + 2 * halo
            assert b.rows >= tm + 2 * halo and b.ld >= tn + 2 * halo
            assert b.ld % 8 == 4 and b.kpad % 8 == 0
            checks = scratch.audit_layout("slab_fold", g, r, t, b,
                                          compute_bytes=cb)
            assert all(c.passed for c in checks), [c.to_dict() for c in checks]


def test_3d_tile_choices_on_the_main_path():
    # 512^3 at h = 4 (Box/Star-3D1R, t = 4): the 16x16x32 tile reads
    # 1.5 * 1.5 * 1.25 = 2.8125x the grid, and both kernels fit it
    g = common.resolve_tile_geom((512, 512, 512), 4)
    assert (g.z_slab, g.strip_m, g.w_tile) == (16, 16, 32)
    assert g.read_amp == pytest.approx(2.8125)
    assert common.launch_grid((512, 512, 512), g) == (16, 32, 32)
    assert common.launch_grid((60, 70, 130), g) == (5, 5, 4)
    # Box-3D2R at t = 4: h = 8 fits only a shallow tile
    g8 = common.resolve_tile_geom((512, 512, 512), 8)
    assert (g8.z_slab, g8.strip_m, g8.w_tile) == (8, 16, 16)
    # the banded layout at R = 1, t = 4 on 16x16x32 (TF32)
    lay = common.banded3d_layout(16, 16, 32, 1, 4, 4)
    assert (lay.planes, lay.rows, lay.ld, lay.a_rows, lay.kpad) == \
        (24, 32, 48, 34, 24)


def test_3d_pins_and_too_deep():
    g = common.resolve_tile_geom((64, 64, 64), 2, tile_m=16, w_tile=16)
    assert (g.z_slab, g.strip_m, g.w_tile) == (16, 16, 16)
    assert common.resolve_tile_geom((3, 64, 64), 1).z_slab == 3
    # a tile pinned to the auto tile's TM and TN is that tile
    auto = common.resolve_tile_geom((60, 70, 130), 4)
    assert common.resolve_tile_geom((60, 70, 130), 4, auto.strip_m,
                                    auto.w_tile) == auto
    # h = 10: no reserve fits, so without a launch's own layout the rule
    # refuses; with the tap-sum's rings (Box-3D2R, t = 5) it finds a tile
    with pytest.raises(ValueError, match="too deep"):
        common.resolve_tile_geom((512, 512, 512), 10)
    rings = common.tapsum_need(3, 2, 5, 4, "fused_direct")
    g10 = common.resolve_tile_geom((512, 512, 512), 10, need=rings)
    assert rings.smem(g10.z_slab, g10.strip_m, g10.w_tile) <= \
        common.SMEM_BUDGET_BYTES
    with pytest.raises(ValueError, match="too deep"):
        common.resolve_tile_geom((512, 512, 512), 8, tile_m=64, w_tile=64)
    # h = 12 at t = 6: the rings fit no tile, so the third rung spreads
    # them over a cluster; h = 40 at t = 40, r = 1: 40 rings, of which one
    # CTA holds at most one, fit no cluster of 8 CTAs, so the fourth rung
    # puts them in a device workspace on the rule's first candidate
    rings12 = common.tapsum_need(3, 2, 6, 4, "fused_direct")
    g12 = common.resolve_tile_geom((512, 512, 512), 12, need=rings12)
    assert rings12.smem(g12.z_slab, g12.strip_m, g12.w_tile) > \
        common.SMEM_BUDGET_BYTES
    lay = rings12.cluster(g12.z_slab, g12.strip_m, g12.w_tile,
                          common.SMEM_BUDGET_BYTES)
    assert lay.ctas in (2, 4, 8) and lay.smem_bytes <= common.SMEM_BUDGET_BYTES
    need40 = common.tapsum_need(3, 1, 40, 4, "fused_direct")
    g40 = common.resolve_tile_geom((512, 512, 512), 40, need=need40)
    assert (g40.z_slab, g40.strip_m, g40.w_tile) == (16, 64, 64)
    assert need40.smem(1, 16, 16) > common.SMEM_BUDGET_BYTES
    assert need40.cluster(16, 16, 16, common.SMEM_BUDGET_BYTES) is None
    lay = need40.workspace(16, 64, 64)
    assert lay.base == common.direct3d_layout(64, 64, 1, 40)


#: Star-3D3R at t = 4 (h = 12): every regime builds -- the step-wise ones
#: at halo 3, the tap-sum's rings (33 slots of 40 x 40 at r = 3: 211,728
#: bytes) and the reuse fold's slab on one CTA, the composed slab (radius
#: 12), which fits no CTA, over a cluster; at t = 10 (h = 30) the fused
#: regimes' layouts fit no one CTA, and the folds' no cluster of 8 CTAs
#: either (the tap-sum's cluster form takes radii up to 2), so they build
#: on the fourth rung, their layouts in a device workspace.
_H30_BUILDS = {"direct": True, "fused_direct": True, "matmul": True,
               "fused_matmul": True, "fused_matmul_reuse": True}


@functools.lru_cache(maxsize=None)
def _h12_oracle():
    w = make_weights(StencilSpec("star", 3, 3), seed=0)
    return np.asarray(j_ref(_grid((20, 24, 30))[2], w, 4))


@pytest.mark.parametrize("backend", ["direct", "fused_direct", "matmul",
                                     "fused_matmul", "fused_matmul_reuse",
                                     None])
def test_too_deep_raises_when_the_plan_is_built(backend):
    # h = t*r = 12 past every reserve builds and matches the oracle, past
    # one CTA on a cluster; h = 30, past every cluster of 8 CTAs, builds
    # too, its fused launch in the workspace form, and would raise "too
    # deep" naming the regime when built (never at launch) where it did not
    w = make_weights(StencilSpec("star", 3, 3), seed=0)
    x, xt, _ = _grid((20, 24, 30))
    build = lambda b, shape, t: tk.stencil_plan(w, shape, torch.float32, t,
                                                device="cpu", backend=b,
                                                use_cache=False)
    y = build(backend, (20, 24, 30), 4)(xt)
    np.testing.assert_allclose(y.numpy(), _h12_oracle(), rtol=0,
                               atol=tolerance(x, torch.float32, 4))
    plan = importlib.import_module("repro_torch.kernels.plan")
    deep = (32, 40, 48)
    name = backend or plan.auto_decision(plan.spec_from_weights(w), deep,
                                         torch.float32, 10)[1].backend
    if not _H30_BUILDS[name]:
        with pytest.raises(ValueError, match=f"too deep.*{name}'s own "
                                             "layout needs at least"):
            build(backend, deep, 10)
    else:
        build(backend, deep, 10)
    # h = 9, the deepest the reserves admit, builds on every backend
    tk.stencil_plan(w, (64, 64, 64), torch.float32, 3, device="cpu",
                    backend=backend, use_cache=False)


@pytest.mark.parametrize("args", [
    ((32, 64, 128), dict(z_slab=16, strip_m=32, h_block=4, z_block=4)),
    ((32, 64, 128), dict(z_slab=8, strip_m=16, h_block=2, z_block=2,
                         w_tile=32, w_block=2)),
    ((512, 512, 512), dict(z_slab=16, strip_m=16, h_block=4, z_block=4,
                           w_tile=32, w_block=4))])
def test_3d_traffic_model_parity(args):
    shape, kw = args
    jg = jcommon.SubstrateGeom(dim=3, **kw)
    tg = common.SubstrateGeom(dim=3, **kw)
    for bands in (None, (9, 18, 16)):
        assert jcommon.hbm_read_bytes_per_step_3d(shape, jg, 4, bands) == \
            common.hbm_read_bytes_per_step_3d(shape, tg, 4, bands)
    assert jg.read_amp == tg.read_amp and jg.describe() == tg.describe()


# ---------------------------------------------------------------------------
# The argument rule: both packages reject the same grids
# ---------------------------------------------------------------------------
def _runs(fn) -> bool:
    try:
        fn()
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("shape,r", [((2, 16, 16), 3), ((16, 2, 16), 3),
                                     ((16, 16, 2), 3), ((2,), 3),
                                     ((3, 16, 16), 3), ((3,), 3)])
def test_radius_guard_on_every_axis(shape, r):
    w = make_weights(StencilSpec("star", len(shape), r), seed=0)
    _, xt, xj = _grid(shape)
    expected = min(shape) >= r
    assert _runs(lambda: t_direct.stencil_direct(xt, w, 1)) == expected
    assert _runs(lambda: t_matmul.stencil_matmul(xt, w, 1)) == expected
    assert _runs(lambda: j_direct(xj, w, 1, interpret=True)) == expected


def test_shallow_leading_axis_runs_where_the_jax_slab_refuses():
    # A periodic leading extent between r and t*r: the port's modulo
    # loads wrap any extent and match the oracle; the JAX slab substrate
    # needs z_slab >= t*r and refuses (ROADMAP queue 3).
    w = make_weights(StencilSpec("box", 3, 1), seed=0)
    x, xt, xj = _grid((3, 16, 16))
    port = t_direct.stencil_direct(xt, w, 4)
    np.testing.assert_allclose(port.numpy(), np.asarray(j_ref(xj, w, 4)),
                               rtol=0, atol=tolerance(x, torch.float32, 4))
    with pytest.raises(ValueError, match="exceeds z_slab"):
        j_direct(xj, w, 4, interpret=True)


def test_cpu_3d_and_1d_never_count_a_launch():
    tk.reset_launch_counts()
    w3 = make_weights(StencilSpec("box", 3, 1), seed=0)
    w1 = make_weights(StencilSpec("box", 1, 1), seed=0)
    for x, w in ((torch.randn(4, 16, 16), w3), (torch.randn(40), w1)):
        t_direct.stencil_direct(x, w, 2)
        t_matmul.stencil_matmul(x, w, 2)
    assert set(tk.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# Plans resolve the launch tile once, when built, and launch on it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid_shape,halo", [((67,), 3), ((40, 37), 2),
                                             ((6, 20, 37), 4)])
def test_launch_geom_by_rank(grid_shape, halo):
    g = common.launch_geom(grid_shape, halo, w_tile=32)
    if len(grid_shape) == 1:
        assert g == common.lifted_tile_geom(grid_shape[0], halo, 32)
    else:
        assert g == common.resolve_tile_geom(grid_shape, halo, None, 32)
    assert (g.w_tile, g.w_block) == (32, halo)


@pytest.mark.parametrize("grid_shape", [(67,), (40, 37), (6, 20, 37)])
@pytest.mark.parametrize("backend", ["direct", "fused_direct", "matmul",
                                     "fused_matmul", "fused_matmul_reuse"])
def test_plan_launches_on_the_tile_it_resolved(monkeypatch, grid_shape,
                                               backend):
    registry = importlib.import_module("repro_torch.kernels.registry")
    seen = []

    def spy(real):
        def at(x, w, t, geom, *rest):
            seen.append((t * ((np.asarray(w).shape[0] - 1) // 2), geom))
            return real(x, w, t, geom, *rest)
        return at
    monkeypatch.setattr(registry, "stencil_direct_at",
                        spy(t_direct.stencil_direct_at))
    monkeypatch.setattr(registry, "stencil_matmul_at",
                        spy(t_matmul.stencil_matmul_at))
    w = make_weights(StencilSpec("box", len(grid_shape), 1), seed=0)
    plan = tk.stencil_plan(w, grid_shape, torch.float32, 2, device="cpu",
                           backend=backend, w_tile=32, use_cache=False)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=grid_shape).astype(np.float32))
    y = plan(x)
    assert len(seen) == (2 if backend in ("direct", "matmul") else 1)
    for halo, geom in seen:
        assert geom == common.launch_geom(grid_shape, halo, None, 32)
    ref = tk.stencil_plan(w, grid_shape, torch.float32, 2, device="cpu",
                          backend="reference", use_cache=False)(x)
    torch.testing.assert_close(y, ref, rtol=0,
                               atol=tolerance(x.numpy(), torch.float32, 2))


def test_resolved_tile_entries_check_the_halo():
    w = make_weights(StencilSpec("box", 3, 1), seed=0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 20, 37)).astype(np.float32))
    g = common.launch_geom(x.shape, 2)
    torch.testing.assert_close(t_direct.stencil_direct_at(x, w, 2, g),
                               t_direct.stencil_direct(x, w, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(t_matmul.stencil_matmul_at(x, w, 2, g),
                               t_matmul.stencil_matmul(x, w, 2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="carries a halo of 2"):
        t_direct.stencil_direct_at(x, w, 1, g)
    with pytest.raises(ValueError, match="carries a halo of 2"):
        t_matmul.stencil_matmul_at(x, w, 3, g)
