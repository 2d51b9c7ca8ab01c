"""The tap-sum kernel module against the JAX ``stencil_direct`` (through its
plain version, which is what a CPU tensor runs), the port's tile geometry
as pure Python, the launch counters and the later-slice guards."""
import importlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.stencil_direct import stencil_direct as j_direct  # noqa: E402
from repro.stencil import StencilSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import scratch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

SHAPES = [(32, 64), (40, 67)]


def _grid(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def tolerance(x: np.ndarray, dtype, t: int, launches: int = 1) -> float:
    """f32: XLA and torch form FMAs differently, 1e-5 * max|x| per step.
    bf16: both round the f32 result once per launch; an f32 difference
    can flip that rounding, so two bf16 ulps of max|x| per launch."""
    mx = float(np.abs(x).max())
    if dtype == torch.bfloat16:
        return launches * 2 * 2.0**-8 * mx
    return 1e-5 * mx * t


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_plain_matches_jax(shape, kind, r, t, dtype):
    w = make_weights(StencilSpec(kind, 2, r), seed=r + t)
    x, xt, xj = _grid(shape, dtype, seed=t)
    port = t_direct.stencil_direct(xt, w, t)          # CPU -> plain version
    assert port.dtype == dtype and tuple(port.shape) == shape
    ref = np.asarray(j_direct(xj, w, t, interpret=True)).astype(np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                               atol=tolerance(x, dtype, t))


def test_plain_direct_is_the_wrapper_on_cpu():
    w = make_weights(StencilSpec("star", 2, 2), seed=0)
    _, xt, _ = _grid((24, 40), torch.float32)
    assert torch.equal(t_direct.stencil_direct(xt, w, 2),
                       t_direct.stencil_direct_plain(xt, w, 2))


def test_nonzero_taps_row_major_and_skip_zeros():
    w = make_weights(StencilSpec("star", 2, 1), seed=0)
    taps = t_direct.nonzero_taps(w)
    assert [(dy, dx) for dy, dx, _ in taps] == [(0, 1), (1, 0), (1, 1),
                                                 (1, 2), (2, 1)]
    assert all(v == float(w[dy, dx]) for dy, dx, v in taps)


@pytest.mark.parametrize("kind,r", [("star", 1), ("box", 3)])
def test_tap_arg_holds_the_tap_list_once_per_weights(kind, r):
    w = make_weights(StencilSpec(kind, 2, r), seed=0).astype(np.float32)
    arg = t_direct._tap_arg(w.tobytes())
    # the (2r+1)^2 taps row-major, zero where skipped, then zero slots
    assert list(arg.w)[:w.size] == w.ravel().tolist()
    assert list(arg.w)[w.size:] == [0.0] * (t_direct.MAX_TAPS - w.size)
    assert t_direct._tap_arg(w.copy().tobytes()) is arg


# ---------------------------------------------------------------------------
# Tile geometry (pure Python): what the kernels launch and read.
# ---------------------------------------------------------------------------
GEOM_CASES = [((32, 64), 1), ((40, 67), 3), ((1000, 1030), 4),
              ((8192, 8192), 4), ((17, 5), 2), ((64, 64), 12), ((300, 200), 24)]


@pytest.mark.parametrize("grid_shape,halo", GEOM_CASES)
def test_tiles_cover_grid_once_and_reads_cover_halo(grid_shape, halo):
    geom = common.resolve_tile_geom(grid_shape, halo)
    assert geom.strip_m % 16 == 0 and geom.w_tile % 16 == 0
    assert (geom.h_block, geom.w_block) == (halo, halo)
    h, w = grid_shape
    if h * w > 10**6:      # sizing only: coverage is checked on the others
        assert (geom.strip_m, geom.w_tile) == (64, 64)
        return
    hits = np.zeros(grid_shape, dtype=int)
    for (r0, r1), (c0, c1), (q0, q1), (p0, p1) in common.tile_windows(
            grid_shape, geom):
        hits[r0:r1, c0:c1] += 1
        assert q0 <= r0 - halo and q1 >= r0 + geom.strip_m + halo
        assert p0 <= c0 - halo and p1 >= c0 + geom.w_tile + halo
        assert (q1 - q0, p1 - p0) == (geom.strip_m + 2 * halo,
                                      geom.w_tile + 2 * halo)
    assert (hits == 1).all()


@pytest.mark.parametrize("grid_shape,halo", GEOM_CASES)
def test_kernel_layouts_fit_under_the_sizing_bound(grid_shape, halo):
    # a call without a layout of its own is held to the 2D tap-sum's: the
    # first candidate on which it fits the budget; every layout a 2D
    # kernel launches with at this halo fits that tile too
    geom = common.resolve_tile_geom(grid_shape, halo)
    tm, tn = geom.strip_m, geom.w_tile
    bound = common.SMEM_BUDGET_BYTES
    for c in common._candidates(grid_shape, halo, None, None, None):
        if (c[1], c[2]) == (tm, tn):
            break
        assert common.direct_layout(c[1], c[2], halo).smem_bytes > bound
    layouts = [common.direct_layout(tm, tn, halo)]
    checks = scratch.audit_layout("tapsum2d", geom, halo, 1, layouts[0])
    for t in range(1, halo + 1):
        if halo % t == 0:
            r = halo // t
            for cb in (4, 2):       # the (2r + 1) rows of a square kernel
                layouts.append(common.tile_fold_layout(tm, tn, r, t, cb,
                                                       2 * r + 1))
                checks += scratch.audit_layout("tile_fold", geom, r, t,
                                               layouts[-1], compute_bytes=cb)
    assert all(c.passed for c in checks), [c.to_dict() for c in checks]
    for lay in layouts:
        assert lay.smem_bytes <= bound
        assert lay.rows >= tm + 2 * halo and lay.ld >= tn + 2 * halo
    for lay in layouts[1:]:
        assert lay.ld % 8 == 4 and lay.kpad % 8 == 0


def test_banded_layout_holds_rounded_steps():
    # r=3, t=4 on a 64 tile: the tile fold holds the step-0 region alone,
    # 88 x 88 (no 16-row rounding: the last row tile is clamped and
    # masked), its rows 4 mod 8 words apart, and the 7 bands' Toeplitz
    # rows of kpad + 16
    lay = common.tile_fold_layout(64, 64, 3, 4, 4, 7)
    assert (lay.planes, lay.rows, lay.ld) == (1, 88, 92)
    assert lay.plane_ld == 88 * 92 and lay.toe_ld == lay.kpad + 16
    assert lay.kpad == 24                      # 16 + 6 -> TF32 K step 8
    # the region, the 1120 bytes of Toeplitz rows 128-byte aligned, headers
    assert lay.smem_bytes == 88 * 92 * 4 + 1152 + 7 * 16
    assert common.tile_fold_layout(64, 64, 3, 4, 2, 7).kpad == 32  # bf16 K 16
    assert common.tile_fold_layout(64, 64, 12, 1, 4, 25).kpad == 40


def test_tile_pins_and_limits():
    g = common.resolve_tile_geom((500, 500), 2, tile_m=32, w_tile=128)
    assert (g.strip_m, g.w_tile) == (32, 128)
    assert common.resolve_tile_geom((20, 500), 2, tile_m=128).strip_m == 32
    with pytest.raises(ValueError, match="multiple of 16"):
        common.resolve_tile_geom((64, 64), 1, tile_m=24)
    with pytest.raises(ValueError, match="too deep"):
        common.resolve_tile_geom((4096, 4096), 200)
    # 3D grids tile too (item 8): the depth clamps to the grid
    g3 = common.resolve_tile_geom((8, 8, 8), 1)
    assert (g3.dim, g3.z_slab, g3.strip_m, g3.w_tile) == (3, 8, 16, 16)
    assert (g3.z_block, g3.h_block, g3.w_block) == (1, 1, 1)
    # deep halos shrink the tile before giving up: at h = 56 the 2D
    # tap-sum's buffers take 247,808 bytes on 64 x 64, 165,888 on 32 x 32
    assert common.resolve_tile_geom((4096, 4096), 24).strip_m == 64
    assert common.resolve_tile_geom((4096, 4096), 56).strip_m == 32


def test_priced_geometry_is_the_launched_tile():
    g = common.resolve_tile_geom((8192, 8192), 4)
    assert g.read_amp == pytest.approx((1 + 8 / 64) ** 2)
    assert common.launch_grid((8192, 8192), g) == (128, 128)
    assert common.launch_grid((1000, 1030), g) == (17, 16)


# ---------------------------------------------------------------------------
# Launch counters and device handling
# ---------------------------------------------------------------------------
def test_cpu_tensors_never_count_a_launch():
    tk.reset_launch_counts()
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = torch.randn(32, 48)
    t_direct.stencil_direct(x, w, 2)
    t_matmul.stencil_matmul(x, w, 2)
    tk.stencil_plan(w, x.shape, torch.float32, 2, device="cpu",
                    backend="fused_matmul")(x)
    tk.stencil_sparse_matmul(x, w, 2)
    tk.stencil_plan(w, x.shape, torch.float32, 2, device="cpu",
                    backend="fused_sparse_matmul")(x)
    tk.stencil_plan(w, x.shape, torch.float32, 2, device="cpu",
                    backend="fused_matmul_reuse_wholestrip")(x)
    counts = tk.launch_counts()
    assert set(counts.values()) == {0}
    assert {"stencil_direct", "stencil_banded", "stencil_direct3d",
            "stencil_banded3d", "stencil_sparse", "stencil_sparse3d",
            "stencil_banded1d", "stencil_sparse1d", "stencil_direct1d",
            "stencil_direct (wholestrip)", "stencil_direct (9tile)",
            "stencil_banded (wholestrip)", "stencil_banded (9tile)",
            "stencil_direct3d (wholeslab)",
            "stencil_banded3d (wholeslab)", "stencil_direct3d (cluster)",
            "stencil_banded3d (cluster)",
            "stencil_sparse3d (cluster)", "stencil_direct (workspace)",
            "stencil_banded (workspace)", "stencil_sparse (workspace)",
            "stencil_direct3d (workspace)", "stencil_banded3d (workspace)",
            "stencil_sparse3d (workspace)"} == set(counts)


def test_other_devices_raise():
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = torch.empty(32, 48, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_direct.stencil_direct(x, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_matmul.stencil_matmul(x, w)


def test_plan_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.stencil_plan(w, (32, 32), torch.float32, 2)
    x = torch.zeros(32, 32)
    assert tk.stencil_apply(x, w, 2).shape == (32, 32)   # x's device: cpu


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "item 15"), (dict(batch=4), "item 13"),
    (dict(audit=True), "item 14")])
def test_later_slices_raise(kwargs, item):
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    if item == "item 15":
        # The distributed stepper (item 15) runs since its port
        # (tests/test_torch_distributed*.py): a mesh without a shard_spec
        # raises JAX's ValueError (plan.py:450-452).
        with pytest.raises(ValueError, match="needs shard_spec"):
            tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                            **kwargs)
        return
    if item == "item 14":
        # The static auditor (item 14) runs since its port: the plan
        # carries a clean report of its own launches.
        plan = tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                               use_cache=False, **kwargs)
        assert plan.audit_report is not None and plan.audit_report.ok
        return
    if item == "item 13":
        # Batched plans (item 13) run since K11; a batch with a mesh
        # raises the JAX ValueError, before the mesh's own refusal.
        plan = tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                               **kwargs)
        assert plan.input_shape == (4, 32, 32)
        with pytest.raises(ValueError, match="distributed meshes"):
            tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                            mesh=object(), **kwargs)


def test_sparse_unit_runs_and_matches_jax():
    # use_sparse_unit=True (item 10) runs: the auto plan of a box kernel
    # at t=2 (the JAX decision under the same tile) matches the JAX plan
    # within the tap-sum tolerance of this file.
    from repro.core import perfmodel as jpm
    from repro.kernels import plan as jplan
    from repro_torch.core import perfmodel as tpm
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x, xt, xj = _grid((32, 32), torch.float32)
    plan = tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                           use_sparse_unit=True)
    hw = jpm.HardwareSpec(**{f: getattr(tpm.H100_SXM_DATASHEET, f) for f in
                             ("name", "p_vector", "p_matrix", "bandwidth",
                              "p_sparse")})
    g = plan.geom
    jd = jplan.decide(StencilSpec("box", 2, 1), 2, 4, hw=hw, tile_n=16,
                      strip_m=g.strip_m, h_block=g.h_block, w_tile=g.w_tile,
                      w_block=g.w_block, use_sparse_unit=True)
    assert (plan.decision.backend, plan.decision.reason) == \
        (jd.backend, jd.reason)
    assert "fused_sparse_matmul" in plan.decision.candidates
    ref = jplan.stencil_plan(w, (32, 32), jnp.float32, 2,
                             backend=plan.backend, use_sparse_unit=True)(xj)
    np.testing.assert_allclose(plan(xt).numpy(), np.asarray(ref), rtol=0,
                               atol=tolerance(x, torch.float32, 2))


@pytest.mark.parametrize("kwargs", [
    dict(boundary="zero"),
    dict(boundary=("reflect", "periodic"), backend="fused_direct")])
def test_boundaries_run_on_the_kernel_backends(kwargs):
    # Per-axis boundaries (item 9) run on every kernel backend, within
    # the tap-sum tolerance of this file (1e-5 * max|x| per step).
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    _, x, _ = _grid((32, 32), torch.float32)
    y = tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                        **kwargs)(x)
    ref = tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                          backend="reference", boundary=kwargs["boundary"])(x)
    torch.testing.assert_close(y, ref, rtol=0,
                               atol=tolerance(x.numpy(), torch.float32, 2))


def test_later_slices_raise_elsewhere():
    w2 = make_weights(StencilSpec("box", 2, 1), seed=0)
    w3 = make_weights(StencilSpec("box", 3, 1), seed=0)
    # 3D grids run (item 8), against the reference backend
    x3 = torch.randn(8, 8, 8, generator=torch.Generator().manual_seed(0))
    y3 = tk.stencil_plan(w3, (8, 8, 8), torch.float32, 1, device="cpu")(x3)
    torch.testing.assert_close(y3, tk.stencil_plan(
        w3, (8, 8, 8), torch.float32, 1, device="cpu",
        backend="reference")(x3), rtol=0, atol=1e-5 * float(x3.abs().max()))
    # guarded execution (item 12) runs: a clean guarded call is the plan's
    torch.testing.assert_close(
        tk.stencil_apply(x3[0], w2, 2, guard=True),
        tk.stencil_apply(x3[0], w2, 2), rtol=0, atol=0)
    # per-axis boundaries run in the kernel wrappers (item 9), and the
    # reference backend honours every boundary
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        t_direct.stencil_direct(x, w2, 2, boundary="zero"),
        tk.stencil_plan(w2, (16, 16), torch.float32, 2, device="cpu",
                        backend="reference", boundary="zero")(x),
        rtol=0, atol=tolerance(x.numpy(), torch.float32, 2))
    y = tk.stencil_plan(w2, (16, 16), torch.float32, 2, device="cpu",
                        backend="reference", boundary="reflect")(x)
    assert torch.isfinite(y).all()
