"""The sparse-compacted banded contraction (``sparse_matmul`` /
``fused_sparse_matmul``) against the JAX package: the host compaction bit
for bit, the plain version against the JAX kernel in interpret mode, the
plans against the JAX plans, the decisions under ``use_sparse_unit=True``
against the JAX ``decide``, and a numpy emulation of the CUDA kernels'
shifted operand reads (the CPU's only check of their index arithmetic)."""
import contextlib
import importlib
import pathlib
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import perfmodel as jpm  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels import stencil_sparse as jsp  # noqa: E402
from repro.kernels.ref import stencil_direct_ref as j_oracle  # noqa: E402
from repro.kernels.stencil_matmul import build_bands_nd as j_bands  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.weights import fuse_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.stencil import StencilSpec, resolve_boundary  # noqa: E402

t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

#: The port's H100 data-sheet spec as a JAX HardwareSpec.
J_H100 = jpm.HardwareSpec(**{f: getattr(tpm.H100_SXM_DATASHEET, f) for f in
                             ("name", "p_vector", "p_matrix", "bandwidth",
                              "p_sparse")})

SHAPES = {1: (67,), 2: (24, 37), 3: (8, 12, 37)}
MIXED = {1: ("reflect",), 2: ("reflect", "periodic"),
         3: ("replicate", "reflect", "periodic")}
BOUNDARIES = [None, "zero", "reflect", "replicate", "mixed"]


def _boundary(b, dim):
    return MIXED[dim] if b == "mixed" else b


def _grid(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def tolerance(x, t, bf16_operands=False):
    """As ``test_torch_plan.tolerance``: f32, 1e-5 * max|x| per step (XLA
    and torch form their sums differently); bf16 operands round every
    step, and an f32 difference can flip a rounding: two bf16 ulps of
    max|x| per step."""
    mx = float(np.abs(x).max())
    if bf16_operands:
        return 2 * 2.0**-8 * mx * t
    return 1e-5 * mx * t


# ---------------------------------------------------------------------------
# Host compaction: bit for bit the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("tile_n", [16, 32])
def test_compaction_matches_jax(kind, dim, r, tile_n):
    w = np.asarray(make_weights(JSpec(kind, dim, r), seed=r), np.float32)
    w2 = w[None, :] if dim == 1 else w
    offsets, bands = j_bands(w2, tile_n)
    t_off, t_bands = t_matmul.build_bands_nd(w2, tile_n)
    assert t_off == offsets and np.array_equal(t_bands, bands)
    j_rows, j_packed = jsp.compact_bands(offsets, bands)
    rows, packed = t_sparse.compact_bands(t_off, t_bands)
    assert len(rows) == len(j_rows)
    assert all(np.array_equal(a, b) for a, b in zip(rows, j_rows))
    assert np.array_equal(packed, j_packed)
    assert t_sparse.band_row_meta(rows, tile_n) == \
        jsp.band_row_meta(j_rows, tile_n)
    s = t_sparse.kept_row_fraction(w, tile_n)
    assert s == jsp.kept_row_fraction(w, tile_n)
    assert s == 1.0 if kind == "box" or dim == 1 else s < 1.0


def test_compaction_errors_match_jax():
    w = np.asarray(make_weights(JSpec("star", 2, 1), seed=0), np.float32)
    offsets, bands = t_matmul.build_bands_nd(w, 16)
    with pytest.raises(ValueError, match="offsets != "):
        t_sparse.compact_bands(offsets[:-1], bands)
    bands[1] = 0
    with pytest.raises(ValueError, match="all-zero"):
        t_sparse.compact_bands(offsets, bands)
    with pytest.raises(ValueError, match="< tile_n"):
        t_sparse.band_row_meta((np.arange(3),), 16)


# ---------------------------------------------------------------------------
# The plain version (what a CPU tensor runs) against the JAX kernel
# ---------------------------------------------------------------------------
PLAIN_CASES = (
    [(2, k, r, t, b) for k in ("box", "star") for r in (1, 2) for t in (1, 3)
     for b in BOUNDARIES]
    + [(3, k, r, t, b) for k in ("box", "star") for r in (1, 2)
       for t in (1, 3) for b in (None, "mixed")]
    + [(1, k, r, t, b) for k in ("box", "star") for r in (1, 2)
       for t in (1, 3) for b in (None, "zero", "reflect")])


@pytest.mark.parametrize("dim,kind,r,t,b", PLAIN_CASES)
def test_plain_matches_jax(dim, kind, r, t, b):
    shape, boundary = SHAPES[dim], _boundary(b, dim)
    w = make_weights(JSpec(kind, dim, r), seed=r + t)
    x = _grid(shape, seed=t)
    port = t_sparse.stencil_sparse_matmul(torch.from_numpy(x), w, t,
                                          boundary=boundary)
    ref = jsp.stencil_sparse_matmul(jnp.asarray(x), w, t, tile_n=16,
                                    interpret=True, boundary=boundary)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=tolerance(x, t))


@pytest.mark.parametrize("dim,kind,t,b", [
    (2, k, t, b) for k in ("box", "star") for t in (1, 3)
    for b in (None, "zero")] + [(3, "star", 3, "mixed"), (1, "box", 3, None)])
def test_plain_bf16_operands_match_jax(dim, kind, t, b):
    shape, boundary = SHAPES[dim], _boundary(b, dim)
    w = make_weights(JSpec(kind, dim, 1), seed=t)
    x = _grid(shape, seed=t)
    port = t_sparse.stencil_sparse_matmul(
        torch.from_numpy(x), w, t, compute_dtype=torch.bfloat16,
        boundary=boundary)
    ref = jsp.stencil_sparse_matmul(jnp.asarray(x), w, t, tile_n=16,
                                    interpret=True,
                                    compute_dtype=jnp.bfloat16,
                                    boundary=boundary)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=tolerance(x, t, bf16_operands=True))


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["box", "star"])
def test_plain_is_the_dense_banded_function(dim, kind):
    # Dropped band rows are exact zeros: the compacted plain version is
    # the dense one's function (sums in another order on the CPU), on a
    # base kernel at depth, a composed kernel and a bf16 grid.
    shape = SHAPES[dim]
    w = make_weights(JSpec(kind, dim, 1), seed=3)
    x = _grid(shape, seed=4)
    xt = torch.from_numpy(x)
    for wk, t, dt in ((w, 3, torch.float32), (fuse_weights(w, 2), 1,
                                              torch.float32),
                      (w, 2, torch.bfloat16)):
        a = t_sparse.stencil_sparse_matmul_plain(xt.to(dt), wk, t,
                                                 boundary="zero")
        b = t_matmul.stencil_matmul_plain(xt.to(dt), wk, t, boundary="zero")
        assert a.dtype == dt and a.shape == xt.shape
        tol = 2.0**-7 * float(a.float().abs().max()) if dt != torch.float32 \
            else 1e-6 * np.abs(x).max()
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


def test_plain_chunk_width_does_not_change_the_function():
    w = make_weights(JSpec("star", 2, 2), seed=0)
    xt = torch.from_numpy(_grid((24, 67)))
    a = t_sparse.stencil_sparse_matmul_plain(xt, w, 2, tile_n=8)
    b = t_sparse.stencil_sparse_matmul_plain(xt, w, 2, tile_n=32)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(xt.abs().max()))


# ---------------------------------------------------------------------------
# Plans under use_sparse_unit=True against the JAX plans and decide()
# ---------------------------------------------------------------------------
PLAN_SHAPES = {1: (67,), 2: (32, 37), 3: (8, 12, 37)}


@pytest.mark.parametrize("backend", ["sparse_matmul", "fused_sparse_matmul",
                                     None])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("b", BOUNDARIES)
def test_plan_matches_jax(backend, dim, b):
    shape, boundary, t = PLAN_SHAPES[dim], _boundary(b, dim), 2
    kind = "star" if dim > 1 else "box"
    w = make_weights(JSpec(kind, dim, 1), seed=dim)
    x = _grid(shape, seed=dim)
    plan = tk.stencil_plan(w, shape, torch.float32, t, device="cpu",
                           backend=backend, boundary=boundary,
                           use_sparse_unit=True)
    jd = jplan.decide(JSpec(kind, dim, 1), t, 4, hw=J_H100, tile_n=16,
                      use_sparse_unit=True,
                      boundary=None if boundary is None else plan.boundary,
                      **tplan.geom_pricing(plan.geom))
    assert (plan.decision.backend, plan.decision.reason) == \
        (jd.backend, jd.reason)
    assert plan.backend == (backend or jd.backend)
    jp = jplan.stencil_plan(w, shape, jnp.float32, t, backend=plan.backend,
                            boundary=boundary, use_sparse_unit=True)
    np.testing.assert_allclose(plan(torch.from_numpy(x)).numpy(),
                               np.asarray(jp(jnp.asarray(x))), rtol=0,
                               atol=tolerance(x, t))


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("backend", ["sparse_matmul", "fused_sparse_matmul"])
def test_sparse_plans_match_the_oracle_at_depth(dim, backend):
    # t = 4 on a radius-2 star (1D: box) under zero walls: halo 8 on every
    # axis (the 3D tile is 8 deep), against the JAX oracle.
    kind = "star" if dim > 1 else "box"
    shape = {1: (67,), 2: (40, 67), 3: (12, 20, 37)}[dim]
    w = make_weights(JSpec(kind, dim, 2), seed=5)
    x = _grid(shape, seed=5)
    y = tk.stencil_plan(w, shape, torch.float32, 4, device="cpu",
                        backend=backend, boundary="zero",
                        use_sparse_unit=True)(torch.from_numpy(x))
    ref = np.asarray(j_oracle(jnp.asarray(x), w, 4, boundary="zero"))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=tolerance(x, 4))


DECISION_CASES = [(dim, kind, r, t, b) for dim in (1, 2, 3)
                  for kind in ("box", "star") for r in (1, 2)
                  for t in (1, 2, 4) for b in (None, "zero", "mixed")
                  if not (dim == 3 and t * r > 8)]


@pytest.mark.parametrize("dim,kind,r,t,b", DECISION_CASES)
def test_decisions_match_jax(dim, kind, r, t, b):
    shape = {1: (4096,), 2: (1024, 1030), 3: (64, 64, 64)}[dim]
    boundary = _boundary(b, dim)
    w = make_weights(JSpec(kind, dim, r), seed=0)
    d = tk.explain(w, t, 4, grid_shape=shape, use_sparse_unit=True,
                   boundary=boundary)
    geom = common.resolve_tile_geom(shape, t * r)
    jd = jplan.decide(JSpec(kind, dim, r), t, 4, hw=J_H100, tile_n=16,
                      use_sparse_unit=True,
                      boundary=None if boundary is None
                      else resolve_boundary(boundary, dim),
                      **tplan.geom_pricing(geom))
    assert (d.backend, d.scenario.name, d.reason) == \
        (jd.backend, jd.scenario.name, jd.reason)
    assert d.candidates == jd.candidates           # same expression order
    assert d.predicted_speedup == jd.predicted_speedup


def test_star_2d_at_t1_is_a_tie_both_packages_break_alike():
    # Star-2D1R at 8192^2, t=1: every regime is memory-bound and prices
    # within the last ulps; both packages pick sparse_matmul.
    shape = (8192, 8192)
    w = make_weights(JSpec("star", 2, 1), seed=0)
    plan = tk.stencil_plan(w, shape, torch.float32, 1, device="cpu",
                           use_sparse_unit=True)
    jd = jplan.decide(JSpec("star", 2, 1), 1, 4, hw=J_H100, tile_n=16,
                      use_sparse_unit=True, **tplan.geom_pricing(plan.geom))
    c = plan.decision.candidates
    assert plan.backend == jd.backend == "sparse_matmul"
    assert c == jd.candidates
    assert max(c.values()) / min(c.values()) - 1 < 1e-12
    assert "sparse-compacted regime wins: kept-row fraction S=0.9259" in \
        plan.decision.reason


def test_use_sparse_unit_is_part_of_the_cache_key():
    tk.clear_plan_cache()
    w = make_weights(JSpec("star", 2, 1), seed=0)
    a = tk.stencil_plan(w, (32, 32), torch.float32, 1, device="cpu")
    b = tk.stencil_plan(w, (32, 32), torch.float32, 1, device="cpu",
                        use_sparse_unit=True)
    assert a is not b and a.key != b.key
    assert "sparse_matmul" not in a.decision.candidates
    assert b.decision.candidates.keys() >= {"sparse_matmul"}
    assert tk.stencil_plan(w, (32, 32), np.float32, 1, device="cpu",
                           use_sparse_unit=1) is b
    assert tk.plan_cache_stats()["hits"] == 1
    tk.clear_plan_cache()


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("shape", [(32, 37), (8, 12, 37), (67,)])
def test_explain_equals_plan_decision(shape, t):
    w = make_weights(JSpec("star", len(shape), 1), seed=0)
    plan = tk.stencil_plan(w, shape, torch.float32, t, device="cpu",
                           use_sparse_unit=True, use_cache=False)
    assert tk.explain(w, t, 4, grid_shape=shape,
                      use_sparse_unit=True) == plan.decision


def test_fallback_ladder_is_the_jax_order():
    ours = tk.fallback_ladder()
    assert ours == tuple(n for n in jreg.fallback_ladder() if n in ours)
    assert ours[1:3] == ("fused_sparse_matmul", "sparse_matmul")
    assert tk.fallback_ladder(after="fused_sparse_matmul")[0] == \
        "sparse_matmul"
    # ties in the selector break by registration order, as in JAX
    names = tk.registered_backends()
    assert names.index("fused_matmul_reuse") < \
        names.index("fused_sparse_matmul") < names.index("sparse_matmul")


def test_stencil_apply_takes_the_sparse_unit():
    w = make_weights(JSpec("star", 2, 1), seed=0)
    x = torch.from_numpy(_grid((32, 48)))
    y = tk.stencil_apply(x, w, 1, use_sparse_unit=True)
    plan = tk.stencil_plan(w, x.shape, x.dtype, 1, device="cpu",
                           use_sparse_unit=True)
    assert torch.equal(y, plan(x))


# ---------------------------------------------------------------------------
# The kernels' operand layout: BandMeta, shared memory, and an emulation
# of the shifted A reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,dim", [("box", 2), ("star", 2), ("box", 3),
                                      ("star", 3)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_base_kernels_need_no_wider_copy(kind, dim, cdt):
    # On star and box base kernels every band ends by the dense kpad, so
    # the compacted kernels launch with the dense kernels' shared memory
    # (the tile fold's layout of the same bands in 2D, the slab fold's in
    # 3D).
    for r in (1, 2, 3):
        w = make_weights(StencilSpec(kind, dim, r), seed=0)
        meta = t_sparse.band_meta(w, cdt)
        geom = common.launch_geom((64,) * dim, r)
        lay = t_sparse.sparse_tile_layout((64,) * dim, w, 1, geom, cdt)
        dense = (common.slab_fold_layout(geom.z_slab, geom.strip_m,
                                         geom.w_tile, r, 1, cdt.itemsize,
                                         len(meta.rows))
                 if dim == 3 else
                 common.tile_fold_layout(geom.strip_m, geom.w_tile, r, 1,
                                         cdt.itemsize, len(meta.rows)))
        assert meta.a_cols == dense.kpad == lay.a_cols
        assert lay.smem_bytes == dense.smem_bytes


def test_band_meta_of_a_shifted_band():
    # A band whose taps sit at dx = 3, 4 of a radius-2 row: lo = 3,
    # span = 1, so kpad_p = 24 in TF32 and the band reads 27 chunk
    # columns, past the dense kpad of 24; in bf16 kpad_p = 32 and a_cols =
    # 35.  The tile fold reads them from the region, masked at the chunk's
    # kv, so the compacted layout is the dense one's (no wider copy).
    w = np.zeros((5, 5), np.float32)
    w[2, 2], w[0, 3], w[0, 4] = 1.0, 0.5, 0.25
    f32 = t_sparse.band_meta(w, torch.float32)
    assert f32.rows == ((0, 3, 3), (2, 2, 2)) and f32.a_cols == 27
    assert f32.packed.shape == (24 + 16, 16)
    bf16 = t_sparse.band_meta(w, torch.bfloat16)
    assert bf16.rows == ((0, 3, 2), (2, 2, 1)) and bf16.a_cols == 35
    lay = t_sparse.sparse_tile_layout((64, 64), w, 1,
                                      common.launch_geom((64, 64), 2),
                                      torch.float32)
    assert lay == common.tile_fold_layout(64, 64, 2, 1, 4, 2, 24, 27)
    assert lay.smem_bytes == \
        common.tile_fold_layout(64, 64, 2, 1, 4, 2).smem_bytes


def test_layout_over_budget_raises():
    # past the 227 KB budget the compacted fold's layout takes the
    # workspace form (the tile rule's fourth rung); the 1D fold, which has
    # none, still raises
    w = make_weights(StencilSpec("box", 3, 1), seed=0)
    big = common.SubstrateGeom(3, strip_m=64, h_block=1, z_slab=16,
                               z_block=1, w_tile=64, w_block=1)
    lay = t_sparse.sparse_tile_layout((64, 64, 64), w, 1, big, torch.float32)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base.smem_bytes > common.SMEM_BUDGET_BYTES
    line = common.SubstrateGeom(1, strip_m=1, h_block=1, w_tile=4096, w_block=1)
    with pytest.raises(ValueError, match="227 KB"):
        t_sparse.sparse_tile_layout((2 ** 20,), np.ones(3, np.float32), 8, line,
                                    torch.float32)


def _emulated_chunk(region_row, meta, k_step, nc_valid, radius):
    """One output chunk of one kernel row as the CUDA kernels compute it:
    the chunk's operand copy ``a_cols`` wide (zero at k >= 16 + 2R and
    past the ``nc_valid`` valid columns; NaN beyond ``a_cols``, storage
    the kernel must never read), then for band p nk_p k-steps of K columns
    from lo_p against the band's padded packed rows."""
    band_k = 16 + 2 * radius
    copy = np.full(meta.a_cols + 2 * k_step, np.nan)
    k = np.arange(meta.a_cols)
    copy[:meta.a_cols] = np.where((k < band_k) & (k < nc_valid),
                                  region_row[np.minimum(k, len(region_row)
                                                        - 1)], 0.0)
    out, start = [], 0
    for *_, lo, nk in meta.rows:
        acc = np.zeros(16)
        for ks in range(nk):
            a = copy[lo + ks * k_step: lo + (ks + 1) * k_step]
            b = meta.packed[start + ks * k_step: start + (ks + 1) * k_step]
            acc += a @ b
        out.append(acc)
        start += nk * k_step
    return out


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["star", "box", "composed", "shifted"])
def test_emulated_shifted_reads_are_the_dense_contraction(r, cdt, kind):
    k_step = common.mma_k_step(cdt.itemsize)
    if kind == "composed":
        w = np.asarray(fuse_weights(make_weights(JSpec("star", 2, 1),
                                                 seed=r), r), np.float32)
    elif kind == "shifted":                       # taps at the band's right
        w = np.zeros((2 * r + 1,) * 2, np.float32)
        w[r, r] = 1.0
        w[0, 2 * r - 1:] = (0.5, 0.25)
    else:
        w = np.asarray(make_weights(JSpec(kind, 2, r), seed=r), np.float32)
    radius = (w.shape[0] - 1) // 2
    meta = t_sparse.band_meta(w, cdt)
    offsets, bands = t_matmul.build_bands_nd(w, 16)
    assert len(meta.rows) == len(offsets)
    assert all(lo + nk * k_step <= meta.a_cols for *_, lo, nk in meta.rows)
    rng = np.random.default_rng(r)
    for nc_valid in (16 + 2 * radius, 16 + radius, 5):   # full and ragged
        row = rng.normal(size=16 + 2 * radius)
        got = _emulated_chunk(row, meta, k_step, nc_valid, radius)
        a = np.where(np.arange(16 + 2 * radius) < nc_valid, row, 0.0)
        for p, band in enumerate(bands):
            assert np.isfinite(got[p]).all()
            np.testing.assert_allclose(got[p], a @ band, rtol=0, atol=1e-12)
    kdense = -(-(16 + 2 * radius) // k_step)
    steps = sum(nk for *_, nk in meta.rows)
    assert steps <= kdense * len(meta.rows)
    if kind == "star":                  # fewer MMA k-steps than the dense
        assert steps < kdense * len(meta.rows)


@pytest.mark.parametrize("dim,cdt,steps", [
    (2, torch.float32, (7, 9)), (3, torch.float32, (11, 15)),
    (2, torch.bfloat16, (4, 6)), (3, torch.bfloat16, (6, 10))])
def test_star_k_steps_per_tile(dim, cdt, steps):
    # MMA k-steps per 16x16 output tile and step, compacted against dense.
    w = make_weights(StencilSpec("star", dim, 1), seed=0)
    meta = t_sparse.band_meta(w, cdt)
    k = common.mma_k_step(cdt.itemsize)
    assert (sum(r[-1] for r in meta.rows),
            len(meta.rows) * -(-18 // k)) == steps


# ---------------------------------------------------------------------------
# The C launch calls: signatures, band metadata and mode codes
# ---------------------------------------------------------------------------
def _c_params(kernel: str) -> list:
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           f"{kernel}.cu").read_text()
    sig = re.search(rf'extern "C" int {kernel}_launch\((.*?)\)', src,
                    re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("shape,boundary", [
    ((40, 67), ("reflect", "periodic")), ((6, 20, 37), ("zero", "periodic",
                                                        "replicate")),
    ((67,), ("reflect",))])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_wrappers_pass_the_band_metadata(monkeypatch, shape, boundary, cdt):
    kernel = "stencil_sparse" + ("3d" if len(shape) == 3 else "")
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    launcher = t_sparse._launcher3d if len(shape) == 3 else \
        t_sparse._launcher
    launcher.cache_clear()
    w = np.asarray(make_weights(JSpec("star", len(shape), 1), seed=0),
                   np.float32)
    x = torch.zeros(shape)
    geom = common.launch_geom(shape, 2)
    codes = common.kernel_mode_codes(boundary)
    try:                    # the launchers take (B,) + grid, the lift (1, N)
        if len(shape) == 3:
            t_sparse._launch3d(x[None], w, 2, 1, cdt, geom, codes)
        else:
            w2 = common.lift_weights(w) if len(shape) == 1 else w
            t_sparse._launch2d(x.view(1, 1, -1) if len(shape) == 1
                               else x[None], w2, 2, 1, cdt, geom, codes)
    finally:
        launcher.cache_clear()
        counts = tk.launch_counts()
        tk.reset_launch_counts()
    assert counts[kernel] == 1
    params = _c_params(kernel)
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    assert tuple(args[n] for n in ("mode_z", "mode_y", "mode_x")
                 [-len(codes):]) == codes
    assert (args["t"], args["R"], args["dtype"]) == (2, 1, 0)
    assert args["compute"] == (1 if cdt == torch.bfloat16 else 0)
    assert (args["B"], args["grid_elems"]) == (1, x.numel())
    wk = common.lift_weights(w) if len(shape) == 1 else w
    meta = t_sparse.band_meta(wk, cdt)
    assert args["a_cols"] == meta.a_cols
    lay = t_sparse.sparse_tile_layout((1,) * (len(shape) == 1) + shape, wk,
                                      2, geom, cdt)     # the lift's grid
    assert args["smem_bytes"] == lay.smem_bytes
    assert args["n_rows"] == len(meta.rows) == (5 if len(shape) == 3 else
                                                3 if len(shape) == 2 else 1)
    # each band's (dz, dy, lo, nk), the offsets a lower rank lacks zero
    _, _, rows = t_sparse._device_operand(wk.tobytes(), wk.shape, cdt, "cpu")
    assert args["meta"] == rows.data_ptr()
    assert [tuple(r) for r in rows.tolist()] == \
        [(0,) * (4 - len(m)) + m for m in meta.rows]


def test_cuda_tensors_need_the_kernel_or_raise():
    w = make_weights(StencilSpec("star", 2, 1), seed=0)
    x = torch.empty(32, 48, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_sparse.stencil_sparse_matmul(x, w)
    with pytest.raises(ValueError, match="fusion depth"):
        t_sparse.stencil_sparse_matmul(torch.zeros(32, 48), w, 0)
    geom = common.launch_geom((32, 48), 1)
    with pytest.raises(ValueError, match="carries a halo"):
        t_sparse.stencil_sparse_matmul_at(torch.zeros(32, 48), w, 2, geom)


def test_at_wrapper_on_a_ragged_pinned_tile():
    # the plan's entry on a pinned 16x16 tile of a ragged grid (CPU: the
    # plain version) under a mixed boundary, against the JAX oracle
    w = make_weights(JSpec("star", 2, 2), seed=1)
    x = _grid((40, 67), seed=1)
    geom = common.launch_geom((40, 67), 4, tile_m=16, w_tile=16)
    y = t_sparse.stencil_sparse_matmul_at(torch.from_numpy(x), w, 2, geom,
                                          None, ("reflect", "replicate"))
    ref = np.asarray(j_oracle(jnp.asarray(x), w, 2,
                              boundary=("reflect", "replicate")))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=tolerance(x, 2))

