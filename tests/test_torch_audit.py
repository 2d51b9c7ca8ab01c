"""The static plan auditor on the port's own launches (``repro_torch.audit``)
on the CPU.

Parity with the JAX package (``repro.audit``) on ``scripts/audit.py``'s
matrix: the registry's launch declarations on every shared field, the
priced geometry's byte model, the reason-string witness (JAX's two
negative cases too), alpha, and the JAX mirror's beta against the port's
``reuse_beta``; the plan's audit counters.  Port side: zero violations on
the matrix and the main cells, the closed-form walk against the full walk,
the FLOP mirror against the kernels' emulations (``tests/test_torch_*``),
and every violation class caught: a corrupted window map, a shrunken
staged region, overlapping shared-memory regions, a monkeypatched
``reuse_beta``, the ``geometry`` fault, and a violation that counts but
never fails a build."""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import audit as jaudit  # noqa: E402
from repro.audit import blocks as jblocks, flops as jflops  # noqa: E402
from repro.core import perfmodel as jpm  # noqa: E402
from repro.kernels import explain as jexplain  # noqa: E402
from repro.kernels import plan as jplan, registry as jreg  # noqa: E402
from repro.kernels.common import resolve_substrate_geom  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.boundary import resolve_boundary as jresolve  # noqa
from repro.stencil.weights import jacobi_weights as jjacobi  # noqa: E402
from repro_torch import audit as taudit  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import __main__ as sweep_cli  # noqa: E402
from repro_torch.audit import blocks, flops, scratch  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.kernels import common, plan as tplan  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.stencil import StencilSpec  # noqa: E402
from repro_torch.stencil.boundary import resolve_boundary  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from test_torch_direct_fold import emulate_direct1d  # noqa: E402
from test_torch_line_fold import emulate_fold  # noqa: E402
from test_torch_slab_fold import emulate_slab  # noqa: E402
from test_torch_tapsum2d_fold import emulate_tapsum2d  # noqa: E402
from test_torch_tapsum3d_fold import emulate_tapsum3d  # noqa: E402
from test_torch_tile_fold import emulate_tile  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_matrix():
    spec = importlib.util.spec_from_file_location(
        "jax_audit_script", ROOT / "scripts" / "audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MATRIX


JAX_MATRIX = _jax_matrix()
ROWS = list(range(len(sweep_cli.MATRIX)))
AUDITED = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", "fused_sparse_matmul", "sparse_matmul")


@pytest.fixture(autouse=True)
def _hygiene():
    tfaults.reset_faults()
    tplan.clear_plan_cache()
    yield
    tfaults.reset_faults()
    tplan.clear_plan_cache()


def _jctx(i):
    grid, t, spec_kw, pinned = JAX_MATRIX[i]
    spec = JSpec(**spec_kw)
    return jreg.PlanContext(
        spec=spec, weights=jjacobi(spec), grid_shape=grid,
        dtype=np.dtype(np.float32), t=t, tile_m=None, tile_n=common.BAND_N,
        interpret=True, h_block=pinned.get("h_block"),
        z_slab=pinned.get("z_slab"), z_block=pinned.get("z_block"),
        w_tile=pinned.get("w_tile"), w_block=pinned.get("w_block"),
        boundary=jresolve(pinned.get("boundary"), len(grid)))


def _tctx(i):
    return sweep_cli.context(*sweep_cli.MATRIX[i])


def _tgeom(jgeom):
    """The port's SubstrateGeom of a JAX one (the same fields)."""
    return common.SubstrateGeom(**dataclasses.asdict(jgeom))


def _ctx(grid, t=2, shape="box", r=1, **pins):
    spec = StencilSpec(shape, len(grid), r)
    return treg.PlanContext(
        spec=spec, weights=np.asarray(make_weights(JSpec(shape, len(grid), r),
                                                   seed=r), np.float32),
        grid_shape=tuple(grid), dtype=torch.float32, t=t,
        tile_m=pins.get("tile_m"), w_tile=pins.get("w_tile"),
        z_slab=pins.get("z_slab"),
        boundary=resolve_boundary(pins.get("boundary"), len(grid)),
        compute_dtype=pins.get("compute_dtype"))


def _launch(ctx, backend):
    return treg.get_backend(backend).audit(ctx).launches[0]


# ---------------------------------------------------------------------------
# Parity with the JAX package on scripts/audit.py's matrix
# ---------------------------------------------------------------------------
def test_matrix_is_the_jax_scripts():
    # the same grids, depths and stencils; the port's w_tile pin stands for
    # JAX's (w_tile, w_block) pair, the boundaries are the same
    assert len(JAX_MATRIX) == len(sweep_cli.MATRIX)
    for (jg, jt, jk, jp), (tg, tt, tk_, tp) in zip(JAX_MATRIX,
                                                    sweep_cli.MATRIX):
        assert (jg, jt, jk) == (tg, tt, tk_)
        assert jp.get("boundary") == tp.get("boundary")
        assert jp.get("w_tile") == tp.get("w_tile")
    assert treg.registered_backends() == jreg.registered_backends()


@pytest.mark.parametrize("row", ROWS)
def test_declarations_equal_jax(row):
    """Every shared field of every declared launch: engine, t_inner, halo,
    radius, weights, n_offsets, band_lo / band_spans, bands_shape (at the
    port's chunk width, which the JAX context pins) and boundary."""
    jctx, tctx = _jctx(row), _tctx(row)
    compared = 0
    for name in jreg.registered_backends():
        try:
            jspec = jreg.get_backend(name).audit(jctx)
        except ValueError:          # JAX refuses the pinned foil geometry
            continue
        tspec = treg.get_backend(name).audit(tctx)
        assert (jspec.exempt is None) == (tspec.exempt is None), name
        if jspec.exempt is not None:
            assert tspec.exempt == jspec.exempt.replace(
                "pure-jnp oracle", "plain PyTorch oracle")
            continue
        assert len(tspec.launches) == len(jspec.launches), name
        for jl, tl in zip(jspec.launches, tspec.launches):
            for f in ("engine", "t_inner", "halo", "radius", "n_offsets",
                      "band_lo", "band_spans", "bands_shape"):
                assert getattr(tl, f) == getattr(jl, f), (name, f)
            assert np.array_equal(tl.weights, jl.weights), name
            assert tuple(tl.boundary) == tuple(jl.boundary), name
            assert tl.tile_n == (jl.tile_n if jl.engine != "direct" else 0)
            compared += 1
    assert compared >= 10


@pytest.mark.parametrize("row", ROWS)
def test_priced_geometry_bytes_equal_jax_model(row):
    """``blocks.priced_grid_bytes`` on JAX's launch geometries equals the
    JAX model's ``_model_grid_bytes`` (without and with the bands)."""
    jctx = _jctx(row)
    n = 0
    for name in AUDITED:
        try:
            spec = jreg.get_backend(name).audit(jctx)
        except ValueError:
            continue
        for jl in spec.launches:
            tg = _tgeom(jl.geom)
            assert blocks.priced_grid_bytes(jl.grid_shape, tg, 4) == \
                jblocks._model_grid_bytes(jl, 4)
            if jl.bands_shape is not None:
                assert blocks.priced_grid_bytes(
                    jl.grid_shape, tg, 4, bands_shape=jl.bands_shape) == \
                    jblocks._model_grid_bytes(jl, 4,
                                              bands_shape=jl.bands_shape)
            n += 1
    assert n


@pytest.mark.parametrize("grid,t", [((256, 512), 2), ((192, 160), 4),
                                    ((32, 64, 128), 2), ((1000,), 2)])
def test_reason_read_amp_equals_jax(grid, t):
    # the same reason string and priced geometry: JAX's verdict and number
    spec = JSpec("box", len(grid), 1)
    w = make_weights(spec, seed=1)
    d = jexplain(w, t, dtype_bytes=4, grid_shape=grid)
    geom_px = resolve_substrate_geom(grid, t, 4, None, None, None, None,
                                     None, None)
    jc = jaudit.audit_reason_read_amp(d.reason, grid, geom_px, t, 4)
    tc = taudit.audit_reason_read_amp(d.reason, grid, _tgeom(geom_px), 4)
    assert (tc.passed, tc.skipped) == (jc.passed, jc.skipped) == (True, False)
    assert tc.expected == jc.expected
    assert math.isclose(tc.actual, jc.actual, rel_tol=1e-12)
    # ... and the port's own plan reason on the port's priced tile
    td = tk.explain(np.asarray(w), t, 4, grid_shape=grid)
    tgeom = tplan.auto_decision(StencilSpec("box", len(grid), 1), grid,
                                torch.float32, t)[0]
    own = taudit.audit_reason_read_amp(td.reason, grid, tgeom, 4)
    assert own.passed and math.isclose(own.actual, tgeom.read_amp,
                                       rel_tol=1e-12)


@pytest.mark.parametrize("reason", [
    "no geometry here", "scenario x | substrate read_amp=2.999x (geom)"])
def test_reason_read_amp_negative_cases_equal_jax(reason):
    geom_px = resolve_substrate_geom((256, 512), 2, 4, None, None, None,
                                     None, None, None)
    jc = jaudit.audit_reason_read_amp(reason, (256, 512), geom_px, 2, 4)
    tc = taudit.audit_reason_read_amp(reason, (256, 512), _tgeom(geom_px))
    assert not jc.passed and not tc.passed
    assert (tc.expected, tc.actual) == (jc.expected, jc.actual)


@pytest.mark.parametrize("row", ROWS)
def test_alpha_and_beta_equal_jax(row):
    """alpha: the fused launch's tap count (JAX's declaration) equals the
    port's ``flops/alpha``, both ``fusion_alpha``; beta: the JAX mirror's
    executed points per output point at JAX's geometry equal the port's
    ``reuse_beta`` there (rtol 1e-9)."""
    jctx, tctx = _jctx(row), _tctx(row)
    spec = tctx.spec
    assert tpm.fusion_alpha(spec, tctx.t) == jpm.fusion_alpha(jctx.spec,
                                                              jctx.t)
    if tctx.t > 1 and not (tctx.boundary and any(
            m != "periodic" for m in tctx.boundary)):
        (jl,) = jreg.get_backend("fused_matmul").audit(jctx).launches
        jalpha = np.count_nonzero(jl.weights) / (
            jctx.t * np.count_nonzero(jctx.weights))
        rep = taudit.audit_context(tctx, "fused_matmul")
        c = rep.check("flops/alpha")
        assert c.passed and math.isclose(c.actual, jalpha, rel_tol=1e-12)
        assert math.isclose(c.expected, jalpha, rel_tol=1e-9)
    for name in ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul"):
        try:
            (jl,) = jreg.get_backend(name).audit(jctx).launches
        except ValueError:
            continue
        lg = jl.launch_geometry()
        _, _, points = jflops.mirror_launch_flops(jl, lg)
        jbeta = points / (jl.t_inner * lg.cells * math.prod(lg.out_block))
        g = jl.geom
        tbeta = tpm.reuse_beta(spec, jl.t_inner, strip_m=g.strip_m,
                               z_slab=g.z_slab if g.dim == 3 else None,
                               w_tile=g.w_tile or None)
        assert math.isclose(jbeta, tbeta, rel_tol=1e-9), name


def test_plan_cache_stats_have_the_jax_audit_keys():
    assert set(tplan.plan_cache_stats()) == set(jplan.plan_cache_stats())
    for k in ("audits_run", "audit_violations"):
        assert tplan.plan_cache_stats()[k] == 0


# ---------------------------------------------------------------------------
# Port side: zero violations, the walks, the plan hooks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("row", sweep_cli.MATRIX + sweep_cli.MAIN_CELLS,
                         ids=lambda r: f"{r[0]}-t{r[1]}-{r[2]['shape']}"
                         f"{r[2]['radius']}-{r[3].get('boundary', '')}")
def test_sweep_has_no_violations(row):
    reports, skipped = sweep_cli.sweep([row])
    assert all(r.ok for r in reports), "\n".join(
        r.summary() for r in reports if not r.ok)
    audited = [r for r in reports if r.exempt is None]
    assert len(audited) >= 10
    # only monolithic fusion under a non-periodic boundary is refused
    assert all("monolithic" in s["reason"] for s in skipped)
    for r in audited:
        assert r.check("blocks/priced-vs-launched").passed
        assert r.flops["executed"] >= r.flops["useful"] > 0


def test_cli_exits_zero_and_nonzero_under_the_geometry_fault(
        monkeypatch, tmp_path):
    monkeypatch.setattr(sweep_cli, "MATRIX", sweep_cli.MATRIX[:3])
    out = tmp_path / "a.json"
    assert sweep_cli.main(["--cells", "matrix", "--out", str(out)]) == 0
    assert '"ok": true' in out.read_text()
    with tfaults.inject("geometry"):
        assert sweep_cli.main(["--cells", "matrix", "--out", str(out)]) == 1


WALK_CASES = [
    ((40, 67), "fused_direct", dict(tile_m=16, w_tile=16)),
    ((40, 67), "fused_direct_wholestrip", dict(tile_m=16, w_tile=16)),
    ((40, 67), "matmul", dict(boundary="reflect")),
    ((20, 40, 37), "fused_direct", dict(tile_m=16, w_tile=16, z_slab=4)),
    ((20, 40, 37), "fused_matmul_reuse_wholestrip",
     dict(tile_m=16, w_tile=16, z_slab=4)),
    ((5000,), "fused_direct", dict(w_tile=16)),
    ((5003,), "direct", dict(w_tile=16)),
    ((5000,), "fused_sparse_matmul", dict(w_tile=16)),
    ((1100,), "matmul", dict(w_tile=16, boundary="zero")),
]


@pytest.mark.parametrize("grid,backend,pins", WALK_CASES)
def test_closed_form_equals_the_full_walk(grid, backend, pins):
    launch = _launch(_ctx(grid, **pins), backend)
    walk = blocks.walk_windows(launch, closed_form=False)
    closed = blocks.walk_windows(launch, closed_form=True)
    assert not walk.closed_form and closed.closed_form
    assert walk.ctas == closed.ctas
    assert blocks.window_cells(walk) == blocks.window_cells(closed)
    assert blocks.staged_range(walk) == blocks.staged_range(closed)
    assert blocks.padded_out_cells(walk) == blocks.padded_out_cells(closed)
    by_walk = blocks.audit_blocks(launch, walk) + \
        scratch.audit_scratch(launch, walk)
    by_form = blocks.audit_blocks(launch, closed) + \
        scratch.audit_scratch(launch, closed)
    assert [(c.name, c.passed, c.skipped) for c in by_walk] == \
        [(c.name, c.passed, c.skipped) for c in by_form]
    assert all(c.passed for c in by_walk), [c.to_dict() for c in by_walk
                                            if not c.passed]


def test_staged_cells_of_the_main_tiles():
    # what the counting build counts per CTA on the card (chip_smoke.py,
    # phase audit): the region; the tap-sums' and 1D kernels' granules
    cases = [((8192, 8192), "fused_direct", 72 * 72),
             ((8192, 8192), "direct", 66 * 72),
             ((8192, 8192), "fused_matmul_reuse", 72 * 72),
             ((512, 512, 512), "fused_direct", 24 * 24 * 40),
             ((512, 512, 512), "direct", 18 * 34 * 40),
             ((512, 512, 512), "fused_sparse_matmul", 24 * 24 * 40),
             ((2**26,), "fused_direct", 4096 + 8),
             ((2**26,), "direct", 4096 + 8),       # granule shift 3, +2h
             ((2**26,), "fused_matmul_reuse", 64 * 72)]
    for grid, backend, want in cases:
        ctx = _ctx(grid, t=4)
        launch = _launch(ctx, backend)
        lo, hi, _ = blocks.staged_range(blocks.walk_windows(launch))
        assert lo == hi == want, (grid, backend, lo, hi)


def test_priced_and_launched_geometry_recorded_never_violating():
    # 512^3 Box-3D1R at t=4: the plan prices the 16x16x32 tile at h=4
    # (2.8125), direct launches 16x32x32 at h=1 (1.27), the grid-free
    # strip of the selector prices 1.2656
    rep = taudit.audit_context(_ctx((512, 512, 512), t=4), "direct",
                               flops=False)
    c = rep.check("blocks/priced-vs-launched")
    assert c.passed and not c.skipped
    assert c.expected["priced_amp"] == pytest.approx(2.8125)
    assert c.actual["launched_amp"] == pytest.approx(1.27001953125)
    assert c.actual["grid_free_amp"] == pytest.approx(1.265625)
    assert c.actual["launched_tile"] == (16, 32, 32)


class TestPlanAttachment:
    def test_audit_true_attaches_a_clean_report_and_counts(self):
        w = make_weights(JSpec("box", 2, 1), seed=0)
        plan = tk.stencil_plan(w, (256, 512), torch.float32, 2, device="cpu",
                               audit=True)
        rep = plan.audit_report
        assert rep is not None and rep.ok, rep.summary()
        assert rep.check("blocks/reason-read-amp").passed
        assert rep.flops["unit"] == "vector"
        st = tk.plan_cache_stats()
        assert (st["audits_run"], st["audit_violations"]) == (1, 0)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(256, 512)).astype(np.float32))
        assert plan(x).shape == (256, 512)

    def test_default_is_off_and_the_env_flag_turns_it_on(self, monkeypatch):
        w = make_weights(JSpec("box", 2, 1), seed=0)
        plan = tk.stencil_plan(w, (128, 256), torch.float32, 1, device="cpu",
                               use_cache=False)
        assert plan.audit_report is None
        monkeypatch.setenv("REPRO_AUDIT", "1")
        plan = tk.stencil_plan(w, (128, 256), torch.float32, 1, device="cpu",
                               use_cache=False)
        assert plan.audit_report is not None and plan.audit_report.ok

    def test_batched_plan_is_exempt_not_violating(self):
        plan = tk.stencil_plan(make_weights(JSpec("box", 2, 1), seed=0),
                               (128, 256), torch.float32, 1, device="cpu",
                               audit=True, batch=2, use_cache=False)
        assert plan.audit_report.exempt is not None
        assert plan.audit_report.ok

    def test_an_auditor_crash_is_recorded_never_raised(self, monkeypatch):
        def crash(*a, **k):
            raise RuntimeError("auditor bug")
        monkeypatch.setattr(taudit, "audit_context", crash)
        plan = tk.stencil_plan(make_weights(JSpec("box", 2, 1), seed=0),
                               (128, 256), torch.float32, 1, device="cpu",
                               audit=True, use_cache=False)
        (c,) = plan.audit_report.checks
        assert c.name == "audit/crashed" and not c.passed
        assert tk.plan_cache_stats()["audit_violations"] == 1

    def test_violations_count_but_never_fail_the_build(self):
        before = tk.plan_cache_stats()["audit_violations"]
        with tfaults.inject("geometry", times=math.inf):
            plan = tk.stencil_plan(
                make_weights(JSpec("box", 2, 1), seed=0), (256, 512),
                torch.float32, 2, backend="fused_direct", device="cpu",
                audit=True, use_cache=False)
        assert plan.audit_report is not None and not plan.audit_report.ok
        assert tk.plan_cache_stats()["audit_violations"] > before
        x = torch.zeros(256, 512)
        assert plan(x).shape == (256, 512)

    def test_mesh_still_names_its_item(self, tmp_path):
        # The distributed stepper (item 15) runs since its port: a mesh
        # plan with audit=True carries JAX's exempt report (JAX plan.py
        # _attach_audit), on a one-rank gloo world.
        import datetime
        import inspect
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
            plan = tk.stencil_plan(make_weights(JSpec("box", 2, 1), seed=0),
                                   (32, 32), torch.float32, 1, device="cpu",
                                   mesh=mesh, shard_spec=("x", None),
                                   audit=True, use_cache=False)
        finally:
            dist.destroy_process_group()
        rep = plan.audit_report
        assert rep.exempt == ("distributed stepper wraps the launch in halo "
                              "collectives")
        assert rep.ok and rep.checks == []
        assert rep.exempt.split(" in ")[0] in \
            inspect.getsource(jplan._attach_audit)


# ---------------------------------------------------------------------------
# The FLOP mirror against the kernels' emulations
# ---------------------------------------------------------------------------
def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind,r,t,boundary", [
    ("box", 1, 1, None), ("star", 2, 2, None), ("box", 1, 3, "zero")])
def test_mirror_equals_the_2d_tapsum_emulation(kind, r, t, boundary):
    ctx = _ctx((40, 67), t=t, shape=kind, r=r, tile_m=16, w_tile=16,
               boundary=boundary)
    launch = _launch(ctx, "fused_direct")
    stats = {"granule": 0, "element": 0, "fma": 0}
    emulate_tapsum2d(_x((1, 40, 67)).astype(np.float64), ctx.weights, t,
                     launch.geom, ctx.boundary, stats=stats)
    c = flops.mirror_launch(launch)
    assert c["fma"] == stats["fma"] > 0
    assert flops.independent_count(launch)["fma"] == c["fma"]


@pytest.mark.parametrize("kind,r,t,boundary", [
    ("box", 1, 1, None), ("star", 1, 2, None),
    ("box", 1, 2, ("zero", "periodic", "reflect")),
    ("star", 1, 2, ("reflect", "zero", "periodic"))])
def test_mirror_equals_the_3d_tapsum_emulation(kind, r, t, boundary):
    ctx = _ctx((9, 20, 24), t=t, shape=kind, r=r, tile_m=16, w_tile=16,
               z_slab=4, boundary=boundary)
    launch = _launch(ctx, "fused_direct")
    stats = {"granule": 0, "element": 0, "fma": 0}
    emulate_tapsum3d(_x((1, 9, 20, 24)).astype(np.float64), ctx.weights, t,
                     launch.geom, ctx.boundary, stats=stats)
    assert flops.mirror_launch(launch)["fma"] == stats["fma"] > 0


@pytest.mark.parametrize("r,t,boundary,n", [
    (1, 1, None, 1101), (2, 3, "reflect", 1101), (1, 4, None, 2048)])
def test_mirror_equals_the_1d_tapsum_emulation(r, t, boundary, n):
    ctx = _ctx((n,), t=t, r=r, w_tile=16, boundary=boundary)
    launch = _launch(ctx, "fused_direct")
    stats = {"fma": 0}
    emulate_direct1d(_x(n), ctx.weights, t, launch.geom, ctx.boundary[0],
                     stats=stats)
    c = flops.mirror_launch(launch)
    assert c["fma"] == stats["fma"] > 0
    assert flops.independent_count(launch)["fma"] == c["fma"]


@pytest.mark.parametrize("backend,kind,r,t,cdt", [
    ("fused_matmul_reuse", "box", 1, 2, torch.float32),
    ("fused_sparse_matmul", "star", 1, 3, torch.float32),
    ("fused_matmul", "box", 1, 2, torch.bfloat16),
    ("sparse_matmul", "star", 2, 1, torch.bfloat16)])
def test_mirror_equals_the_tile_fold_emulation(backend, kind, r, t, cdt):
    ctx = _ctx((40, 67), t=t, shape=kind, r=r, tile_m=16, w_tile=16,
               compute_dtype=cdt)
    launch = _launch(ctx, backend)
    w = launch.weights
    stats = {"mma": 0}
    emulate_tile(_x((40, 67)), w, launch.t_inner, launch.geom,
                 ("periodic",) * 2, cdt, "sparse" in backend, stats=stats)
    c = flops.mirror_launch(launch)
    assert c["mma_tiles"] == stats["mma"] > 0
    assert c["mma_issued"] >= c["mma_tiles"]
    assert flops.independent_count(launch)["mma_tiles"] == c["mma_tiles"]


@pytest.mark.parametrize("backend,kind,r,t,cdt", [
    ("fused_matmul_reuse", "box", 1, 2, torch.float32),
    ("fused_sparse_matmul", "star", 1, 2, torch.bfloat16),
    ("matmul", "star", 1, 1, torch.float32)])
def test_mirror_equals_the_slab_fold_emulation(backend, kind, r, t, cdt):
    ctx = _ctx((9, 20, 24), t=t, shape=kind, r=r, tile_m=16, w_tile=16,
               z_slab=4, compute_dtype=cdt)
    launch = _launch(ctx, backend)
    stats = {"mma": 0}
    emulate_slab(_x((9, 20, 24)), launch.weights, launch.t_inner,
                 launch.geom, ("periodic",) * 3, cdt, "sparse" in backend,
                 stats=stats)
    c = flops.mirror_launch(launch)
    assert c["mma_tiles"] == stats["mma"] > 0
    assert flops.independent_count(launch)["mma_tiles"] == c["mma_tiles"]


@pytest.mark.parametrize("backend,r,t", [("fused_matmul_reuse", 1, 2),
                                         ("fused_sparse_matmul", 2, 2),
                                         ("matmul", 1, 1)])
def test_mirror_equals_the_line_fold_emulation(backend, r, t):
    # 48 rows of 16: three whole warps; each 16-column chunk of a row's
    # step is one product per n8 half and k-step of the band
    n = 48 * 16
    ctx = _ctx((n,), t=t, r=r, w_tile=16)
    launch = _launch(ctx, backend)
    stats = {"chunks": 0}
    emulate_fold(_x(n), launch.weights[0], launch.t_inner, launch.geom,
                 "periodic", stats=stats)
    (*_, nk), = launch.band_rows
    c = flops.mirror_launch(launch)
    assert c["mma_tiles"] == stats["chunks"] // 16 * 2 * nk > 0
    assert flops.independent_count(launch)["mma_tiles"] == c["mma_tiles"]


def test_flop_totals_and_zero_k_halves_on_the_main_2d_tile():
    # 8192^2 Box-2D1R, t=4, reuse: 25 tiles a pass on 32 slots at steps
    # 0-2, the TF32 band of 18 rows padded to 24 (its last k4 half zero)
    rep = taudit.audit_context(_ctx((8192, 8192), t=4), "fused_matmul_reuse")
    assert rep.ok, rep.summary()
    f = rep.flops
    assert f["unit"] == "matrix" and f["useful"] == 2 * 9 * 8192 ** 2 * 4
    assert f["redundancy"] == pytest.approx(12.3125)
    assert f["redundancy_tiles"] == pytest.approx(10.4375)
    assert f["zero_k4"] * 3 == f["mma_sync"] // 2


# ---------------------------------------------------------------------------
# Negative tests: every violation class is caught
# ---------------------------------------------------------------------------
def test_the_geometry_fault_breaks_bytes_and_coverage():
    with tfaults.inject("geometry", times=math.inf):
        rep = taudit.audit_context(_ctx((256, 512), t=2), "fused_direct",
                                   flops=False)
    names = {c.name for c in rep.violations}
    assert "blocks/grid-bytes-model" in names
    assert "scratch/coverage-global" in names


@pytest.mark.parametrize("grid", [(256, 512), (32, 64, 128), (5000,)])
def test_a_corrupted_window_map_is_caught(grid):
    pins = dict(w_tile=16) if len(grid) == 1 else {}   # five 1D segments
    launch = _launch(_ctx(grid, t=2, **pins), "fused_direct")
    walk = blocks.walk_windows(launch, closed_form=False)
    outs, wins, staged = walk.entries[1]
    shifted = tuple(tuple((a + 1, b + 1) if ax == 0 else (a, b)
                          for ax, (a, b) in enumerate(win)) for win in wins)
    bad = dataclasses.replace(walk, entries=[walk.entries[0],
                                             (outs, shifted, staged)]
                              + walk.entries[2:])
    checks = blocks.audit_blocks(launch, bad) + \
        scratch.audit_scratch(launch, bad)
    names = {c.name for c in checks if not c.passed and not c.skipped}
    assert "blocks/in-bounds" in names and "scratch/coverage-global" in names


@pytest.mark.parametrize("backend,grid", [
    ("fused_direct", (256, 512)), ("fused_direct", (32, 64, 128)),
    ("fused_matmul_reuse", (256, 512)), ("fused_matmul_reuse", (32, 64, 128))])
def test_a_shrunken_staged_region_is_caught(backend, grid):
    launch = _launch(_ctx(grid, t=2), backend)
    lay = scratch.launch_layout(launch)
    bad = dataclasses.replace(lay, rows=lay.rows - 2)
    names = {c.name for c in scratch.audit_scratch(launch, layout=bad)
             if not c.passed}
    assert "scratch/read-window" in names


@pytest.mark.parametrize("backend,field", [
    ("fused_matmul_reuse", "plane_ld"), ("fused_direct", "plane_ld"),
    ("fused_matmul_reuse", "smem_bytes")])
def test_overlapping_shared_memory_regions_are_caught(backend, field):
    launch = _launch(_ctx((32, 64, 128), t=2), backend)
    lay = scratch.launch_layout(launch)
    shrink = lay.rows * lay.ld // 2 if field == "plane_ld" else 1024
    bad = dataclasses.replace(lay, **{field: getattr(lay, field) - shrink})
    checks = scratch.audit_scratch(launch, layout=bad)
    assert "scratch/slots-partition" in {c.name for c in checks
                                         if not c.passed}


def test_a_monkeypatched_reuse_beta_is_caught(monkeypatch):
    orig = tpm.reuse_beta
    monkeypatch.setattr(tpm, "reuse_beta",
                        lambda *a, **k: orig(*a, **k) * 1.5)
    rep = taudit.audit_context(_ctx((256, 512), t=2), "fused_matmul_reuse")
    names = {c.name for c in rep.violations}
    assert "flops/beta" in names and "flops/matrix-reuse-model" in names


def test_clean_control_has_zero_violations_and_exact_flops():
    for backend in ("fused_direct", "fused_matmul_reuse",
                    "fused_sparse_matmul"):
        rep = taudit.audit_context(_ctx((256, 512), t=2), backend)
        assert rep.ok, rep.summary()
        c = rep.check("flops/structural")
        assert c.passed and c.expected == c.actual
