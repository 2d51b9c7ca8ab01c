"""The port's tile rule past the halos its reserves admit: every tile
the rule resolved before it learned the kernels' own layouts stays the
same, and past the reserves each regime's launch takes the first
candidate its own layout fits, or raises naming itself.

``TILES`` is the tile rule as it stood before its second half (the
reserves of ``common.tile_smem_bound`` only), frozen: for each grid and
pins, the tile at every halo, 2D h = 1..32 and 3D h = 1..9, "-" where it
refused.  ``AUTO`` is the auto decision at full width (8192^2, 512^3, f32)
for t = 1..8, each without and with ``use_sparse_unit``, "-" where it
refused; the JAX ``decide`` asked the same question is checked in
tests/test_torch_wide.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.plan import auto_decision
from repro_torch.stencil.spec import StencilSpec

#: The tile before the rule's second half: (grid, pins) -> tiles by halo.
TILES = {
    ((8192, 8192), ()): '64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 16x16 16x16 16x16 16x16 16x16 16x16 16x16',
    ((1000, 1030), ()): '64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 16x16 16x16 16x16 16x16 16x16 16x16 16x16',
    ((128, 128), ()): '64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 16x16 16x16 16x16 16x16 16x16 16x16 16x16',
    ((100, 130), ()): '64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 64x64 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 32x32 16x16 16x16 16x16 16x16 16x16 16x16 16x16',
    ((500, 500), (('tile_m', 32), ('w_tile', 128))): '32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 32x128 - - - - - - - - - - - - - - - -',
    ((4096, 4096), (('tile_m', 16),)): '16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32',
    ((1, 67108864), ()): '16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x64 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32',
    ((1, 5000), (('w_tile', 32),)): '16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32 16x32',
    ((512, 512, 512), ()): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 8x16x32 8x16x16 8x16x16 2x16x16',
    ((60, 70, 130), ()): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 8x16x32 8x16x16 8x16x16 2x16x16',
    ((40, 72, 100), ()): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 8x16x32 8x16x16 8x16x16 2x16x16',
    ((20, 24, 40), ()): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 8x16x32 8x16x16 8x16x16 2x16x16',
    ((40, 40, 40), ()): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 8x16x32 8x16x16 8x16x16 2x16x16',
    ((512, 512, 512), (('z_slab', 4),)): '4x64x64 4x64x32 4x64x32 4x32x32 4x32x32 4x32x16 4x16x32 4x16x16 -',
    ((64, 64, 64), (('tile_m', 16), ('w_tile', 16))): '16x16x16 16x16x16 16x16x16 16x16x16 16x16x16 8x16x16 8x16x16 8x16x16 2x16x16',
    ((60, 70, 130), (('z_slab', 16),)): '16x32x32 16x16x32 16x16x32 16x16x32 16x16x16 - - - -',
}

#: The auto decision before the rule's second half, by pattern.
AUTO = {
    'Box-2D1R': 'direct direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct',
    'Box-2D3R': 'direct direct fused_matmul_reuse fused_matmul_reuse fused_matmul fused_matmul fused_matmul_reuse fused_matmul_reuse fused_matmul_reuse fused_matmul fused_matmul fused_matmul fused_matmul fused_matmul fused_direct fused_matmul',
    'Box-2D7R': 'matmul matmul fused_matmul_reuse fused_matmul fused_matmul fused_matmul fused_matmul fused_matmul - - - - - - - -',
    'Star-2D1R': 'direct sparse_matmul fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_matmul fused_matmul fused_direct fused_direct fused_direct fused_direct',
    'Star-2D3R': 'direct direct fused_direct fused_direct fused_matmul fused_sparse_matmul fused_direct fused_direct fused_matmul_reuse fused_matmul_reuse fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct',
    'Box-3D1R': 'matmul matmul fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_sparse_matmul fused_direct fused_direct fused_direct fused_direct',
    'Box-3D2R': 'matmul matmul fused_matmul_reuse fused_matmul fused_direct fused_sparse_matmul fused_direct fused_direct - - - - - - - -',
    'Star-3D1R': 'direct direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct fused_matmul fused_matmul fused_direct fused_direct fused_direct fused_direct fused_direct fused_direct',
    'Star-3D2R': 'direct sparse_matmul fused_matmul fused_matmul fused_direct fused_sparse_matmul fused_matmul fused_matmul - - - - - - - -',
}


PATTERNS = tuple(AUTO)


def _tile(g) -> str:
    return (f"{g.z_slab}x{g.strip_m}x{g.w_tile}" if g.dim == 3
            else f"{g.strip_m}x{g.w_tile}")


def _needs(grid, h):
    """A launch's own layout of every family at halo h on this grid's rank
    (radius 1 at t = h, the most slots a tap-sum ring takes per halo)."""
    dim = 1 if grid[0] == 1 and len(grid) == 2 else len(grid)
    return [common.tapsum_need(dim, 1, h, 4, "fused_direct"),
            common.fold_need(dim, 1, h, 4, 4, 3 ** (dim - 1),
                             "fused_matmul_reuse"),
            common.fold_need(dim, h, 1, 4, 4, (2 * h + 1) ** (dim - 1),
                             "fused_matmul")]


@pytest.mark.parametrize("key", list(TILES), ids=str)
def test_frozen_tiles_are_kept(key):
    # every halo the reserves admitted keeps its tile, with or without a
    # launch's own layout; where they refused, a launch with no layout
    # of its own still refuses
    grid, pins = key
    pins = dict(pins)
    for h, want in enumerate(TILES[key].split(), start=1):
        args = (grid, h, pins.get("tile_m"), pins.get("w_tile"),
                pins.get("z_slab"))
        if want == "-":
            with pytest.raises(ValueError, match="too deep|z_slab="):
                common.resolve_tile_geom(*args)
            continue
        g = common.resolve_tile_geom(*args)
        assert _tile(g) == want
        assert (g.h_block, g.w_block) == (h, h)
        for need in _needs(grid, h):
            assert common.resolve_tile_geom(*args, need=need) == g
        assert common.priced_tile_geom(*args, needs=_needs(grid, h)) == g


@pytest.mark.parametrize("name", PATTERNS)
def test_frozen_auto_decisions_are_kept(name):
    # every signature auto decided before decides the same; the ones it
    # refused are priced now, at the tile the fused layouts fit
    spec = StencilSpec.from_name(name)
    shape = (8192, 8192) if spec.dim == 2 else (512,) * 3
    want = iter(AUTO[name].split())
    for t in range(1, 9):
        for sparse in (False, True):
            w = next(want)
            g, d = auto_decision(spec, shape, torch.float32, t,
                                 use_sparse_unit=sparse)
            assert (g.h_block, g.w_block) == (t * spec.radius,) * 2
            if w != "-":
                assert d.backend == w


# ---------------------------------------------------------------------------
# The rule's second half
# ---------------------------------------------------------------------------
#: Past the reserves, each regime's least footprint at Box-2D7R t = 8 (h =
#: 56) on 8192^2 and its tile: the tap-sum's two buffers fit 32 x 32, the
#: folds' single region 64 x 64 (the composed fold 128 deep, 113 bands).
DEEP_2D = [
    (common.tapsum_need(2, 7, 8, 4, "fused_direct"), "32x32"),
    (common.fold_need(2, 7, 8, 4, 4, 15, "fused_matmul_reuse"), "64x64"),
    (common.fold_need(2, 56, 1, 4, 4, 113, "fused_matmul"), "64x64"),
    (common.fold_need(2, 56, 1, 4, 2, 113, "fused_matmul"), "64x64"),
]


@pytest.mark.parametrize("need,want", DEEP_2D, ids=lambda v: getattr(
    v, "regime", v))
def test_deep_2d_tiles_are_the_first_that_fit(need, want):
    budget = common.SMEM_BUDGET_BYTES
    g = common.resolve_tile_geom((8192, 8192), 56, need=need)
    assert _tile(g) == want and g.h_block == g.w_block == 56
    assert need.smem(1, g.strip_m, g.w_tile) <= budget
    # every larger candidate in the rule's order does not fit
    for c in common._candidates((8192, 8192), 56, None, None, None):
        if c[1] == g.strip_m:
            break
        assert need.smem(*c) > budget


def test_the_least_footprints_of_the_deep_halos():
    # the least footprints of the deep halos (16 x 16 tiles, tz = 1)
    assert common.direct_layout(16, 16, 56).smem_bytes == 131120
    assert common.tile_fold_layout(16, 16, 7, 8, 4, 15).smem_bytes == 70768
    assert common.tile_fold_layout(16, 16, 56, 1, 4, 113).smem_bytes == 134544
    assert common.direct3d_layout(16, 16, 2, 6).smem_bytes == 237408
    assert common.slab_fold_layout(1, 16, 16, 2, 6, 4, 25).smem_bytes == 182160
    assert common.slab_fold_layout(1, 16, 16, 2, 8, 4, 25).smem_bytes == 336144


@pytest.mark.parametrize("h,regime,fits", [
    (10, "fused_direct", True), (12, "fused_direct", False),
    (12, "fused_matmul_reuse", True), (14, "fused_matmul_reuse", True),
    (16, "fused_matmul_reuse", False), (10, "fused_matmul", True),
    (12, "fused_matmul", False)])
def test_deep_3d_tiles_and_refusals(h, regime, fits):
    # Box-3D2R at t = h / 2 on 512^3: a layout that fits one CTA takes the
    # tile of least read amplification it fits; one that fits none takes
    # the first tile, in the same order, on which it spread over the least
    # cluster of 2, 4 or 8 CTAs fits each CTA's share (the third rung)
    t = h // 2
    budget = common.SMEM_BUDGET_BYTES
    need = {"fused_direct": common.tapsum_need(3, 2, t, 4, regime),
            "fused_matmul_reuse": common.fold_need(
                3, 2, t, 4, 4, 25, regime, dzs=tuple(i // 5 for i in range(25))),
            "fused_matmul": common.fold_need(
                3, h, 1, 4, 4, (2 * h + 1) ** 2, regime,
                dzs=tuple(i // (2 * h + 1) for i in range((2 * h + 1) ** 2)))}[regime]
    g = common.resolve_tile_geom((512,) * 3, h, need=need)
    assert g.z_block == g.h_block == g.w_block == h
    order = common._candidates((512,) * 3, h, None, None, None)
    tile = (g.z_slab, g.strip_m, g.w_tile)
    if fits:
        assert need.smem(*tile) <= budget
        assert tile == next(c for c in order if need.smem(*c) <= budget)
        return
    assert all(need.smem(*c) > budget for c in order)
    assert tile == next(c for c in order if need.cluster(*c, budget))
    lay = need.cluster(*tile, budget)
    assert lay.ctas in common.CLUSTER_SIZES and max(lay.shares) <= budget
    assert lay.smem_bytes == max(lay.shares)


def test_halos_past_one_cta_stay_refused():
    # 2D h = 200: no layout of any family fits a 16 x 16 tile
    for need in _needs((4096, 4096), 200):
        with pytest.raises(ValueError, match="too deep"):
            common.resolve_tile_geom((4096, 4096), 200, need=need)


def test_the_degraded_budget_refuses_earlier(monkeypatch):
    # the guard's degraded rung halves the budget: the rule's second half
    # holds the candidates to it too (Box-2D7R t = 8: the reuse fold's
    # 64 x 64 no longer fits, 32 x 32 does; the composed fold fits none)
    reuse = common.fold_need(2, 7, 8, 4, 4, 15, "fused_matmul_reuse")
    composed = common.fold_need(2, 56, 1, 4, 4, 113, "fused_matmul")
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(common.SMEM_BUDGET_BYTES // 2))
    g = common.resolve_tile_geom((8192, 8192), 56, need=reuse)
    assert (g.strip_m, g.w_tile) == (32, 32)
    with pytest.raises(ValueError, match="fused_matmul's own layout"):
        common.resolve_tile_geom((8192, 8192), 56, need=composed)


@pytest.mark.parametrize("grid,h", [((300, 270), 56), ((128, 128), 35),
                                    ((40, 40, 40), 10), ((60, 70, 130), 14)])
def test_tile_windows_cover_the_grid_at_the_new_tiles(grid, h):
    # every output cell in exactly one CTA, each CTA reading its tile and
    # the h-deep halo on every axis, on the tiles of the rule's second half
    dim = len(grid)
    need = (common.tapsum_need(dim, 7, h // 7, 4, "fused_direct")
            if dim == 2 else common.fold_need(dim, 2, h // 2, 4, 4, 25,
                                              "fused_matmul_reuse"))
    g = common.resolve_tile_geom(grid, h, need=need)
    hits = np.zeros(grid, np.int32)
    for win in common.tile_windows(grid, g):
        outs, reads = win[:dim], win[dim:]
        hits[tuple(slice(a, b) for a, b in outs)] += 1
        for (o0, o1), (r0, r1) in zip(outs, reads):
            assert r0 == o0 - h and r1 >= o1 + h
    assert (hits == 1).all()
