"""Per-axis boundaries (zero, reflect, replicate, mixed with periodic)
through the port against the JAX package: every regime under every mode at
ranks 1-3 against the JAX oracle (and a few 2D cases against the JAX plan
in interpret mode), ``fused_matmul``'s refusal and the selector's
avoidance of it, the plan-cache keys and reason strings of the periodic
pin, the rejected grids of both packages, ragged and shallow tiles (with
an emulation of the kernels' tile-by-tile fill on the CPU), and the mode
codes the wrappers hand the CUDA launchers."""
import contextlib
import functools
import importlib
import itertools
import pathlib
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import explain as j_explain  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import stencil_apply as j_apply  # noqa: E402
from repro.kernels import stencil_plan as j_stencil_plan  # noqa: E402
from repro.kernels.common import validate_tiling  # noqa: E402
from repro.kernels.stencil_direct import stencil_direct as j_direct  # noqa
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil_steps as j_steps  # noqa
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from test_torch_plan import J_H100  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul_reuse", None,
           "reference")                                   # None = auto
MODES_2D = ("zero", "reflect", "replicate", ("reflect", "periodic"),
            ("periodic", "zero"))
MODES_3D = ("zero", "reflect", "replicate",
            ("replicate", "reflect", "periodic"))
MODES_1D = ("zero", "reflect", "replicate")


@pytest.fixture(autouse=True)
def _hygiene():
    tk.clear_plan_cache()
    jplan.clear_plan_cache()
    yield
    tk.clear_plan_cache()
    jplan.clear_plan_cache()


def tolerance(x: np.ndarray, t: int) -> float:
    """f32 against the JAX oracle: the port accumulates in its own order
    (the tap-sum skips zero taps, the banded plain version sums band rows
    by matmul), 1e-5 * max|x| per step, as the other port tests."""
    return 1e-5 * float(np.abs(x).max()) * t


@functools.lru_cache(maxsize=None)
def _case(kind, r, shape, t, boundary, seed=0):
    """Weights, grid and the JAX oracle of one case, computed once."""
    w = make_weights(JSpec(kind, len(shape), r), seed=r + seed)
    x = np.random.default_rng(seed + t).normal(size=shape).astype(np.float32)
    ref = np.asarray(j_steps(jnp.asarray(x), jnp.asarray(w, jnp.float32), t,
                             boundary))
    return w, x, ref


def run_port(w, x, t, boundary, backend, **kw):
    plan = tk.stencil_plan(w, x.shape, torch.float32, t, backend=backend,
                           boundary=boundary, device="cpu", **kw)
    y = plan(torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    return plan, y.numpy()


def _label(b):
    return b if isinstance(b, str) else "x".join(b)


# ---------------------------------------------------------------------------
# Every regime under every mode, ranks 1-3, against the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", REGIMES)
@pytest.mark.parametrize("boundary", MODES_2D, ids=_label)
def test_every_regime_every_mode_2d(boundary, backend):
    # TestAllModesAllBackends' grid: Star-2D2R, t=2, 64x128
    w, x, ref = _case("star", 2, (64, 128), 2, boundary)
    plan, y = run_port(w, x, 2, boundary, backend)
    assert plan.backend != "fused_matmul"
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 2))


@pytest.mark.parametrize("wid", [257, 300])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("kind,r", [("box", 1), ("box", 2), ("star", 1),
                                    ("star", 2)])
def test_mixed_2d_remainder_widths(kind, r, t, wid):
    # TestMixedModeGrids: periodic x, reflect y, on remainder widths
    b = ("reflect", "periodic")
    w, x, ref = _case(kind, r, (64, wid), t, b)
    for backend in REGIMES + (("fused_matmul",) if t == 1 else ()):
        _, y = run_port(w, x, t, b, backend)
        np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, t),
                                   err_msg=str(backend))


@pytest.mark.parametrize("backend", REGIMES)
@pytest.mark.parametrize("boundary", MODES_3D, ids=_label)
def test_every_regime_every_mode_3d(boundary, backend):
    # TestMixedModeGrids.test_3d_mixed_modes' grid: Star-3D1R, t=2
    w, x, ref = _case("star", 1, (8, 16, 128), 2, boundary)
    _, y = run_port(w, x, 2, boundary, backend)
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 2))


@pytest.mark.parametrize("backend", REGIMES)
@pytest.mark.parametrize("boundary", MODES_1D)
def test_every_regime_every_mode_1d(boundary, backend):
    # TestAllModesAllBackends.test_uniform_mode_1d: Box-1D2R, t=2, 512
    w, x, ref = _case("box", 2, (512,), 2, boundary)
    _, y = run_port(w, x, 2, boundary, backend)
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 2))


@pytest.mark.parametrize("shape,kind,r", [((64, 128), "box", 1),
                                          ((8, 16, 128), "star", 1),
                                          ((512,), "box", 2)])
@pytest.mark.parametrize("mode", ["zero", "reflect", "replicate"])
def test_monolithic_fusion_runs_at_t1(shape, kind, r, mode):
    # t=1: the composed kernel IS one step, so every mode is legal
    w, x, ref = _case(kind, r, shape, 1, mode)
    _, y = run_port(w, x, 1, mode, "fused_matmul")
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 1))


@pytest.mark.parametrize("backend,boundary", [
    ("direct", ("reflect", "periodic")), ("fused_matmul_reuse", "zero"),
    ("fused_direct", "replicate")])
def test_2d_matches_the_jax_plan(backend, boundary):
    w, x, _ = _case("box", 1, (64, 257), 2, boundary)
    _, y = run_port(w, x, 2, boundary, backend)
    ref = np.asarray(j_apply(jnp.asarray(x), w, 2, backend=backend,
                             boundary=boundary, interpret=True))
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 2))


# ---------------------------------------------------------------------------
# Monolithic fusion refuses t > 1; auto avoids it, as the JAX decide does
# ---------------------------------------------------------------------------
def test_monolithic_fusion_refuses_nonperiodic_multistep():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    for pkg in (lambda **k: tk.stencil_plan(w, (64, 128), torch.float32, 2,
                                            device="cpu", **k),
                lambda **k: j_stencil_plan(w, (64, 128), np.float32, 2,
                                           interpret=True, **k)):
        with pytest.raises(ValueError, match="monolithic fusion"):
            pkg(backend="fused_matmul", boundary="zero")
        pkg(backend="fused_matmul", boundary="periodic")       # builds


def check_decision(plan, t, boundary):
    """The port's decision equals the JAX ``decide`` asked the same
    question (H100 spec, the port's tile) under the same boundary."""
    g, dim = plan.geom, plan.spec.dim
    geo = {}
    if dim >= 2:
        geo = dict(strip_m=g.strip_m, h_block=g.h_block, w_tile=g.w_tile,
                   w_block=g.w_block)
    if dim == 3:
        geo.update(z_slab=g.z_slab, z_block=g.z_block)
    jd = jplan.decide(JSpec(plan.spec.shape, dim, plan.spec.radius), t, 4,
                      hw=J_H100, tile_n=16, boundary=boundary, **geo)
    d = plan.decision
    assert (d.backend, d.scenario.name, d.reason) == \
        (jd.backend, jd.scenario.name, jd.reason)
    assert d.candidates.keys() == jd.candidates.keys()


@pytest.mark.parametrize("shape,kind,boundary", [
    ((256, 512), "box", "reflect"), ((256, 512), "star", "zero"),
    ((64, 64, 64), "box", ("replicate", "reflect", "periodic")),
    ((4096,), "box", "reflect")])
def test_auto_avoids_monolithic_and_matches_jax_decide(shape, kind, boundary):
    w, x, ref = _case(kind, 1, shape, 4, boundary)
    plan, y = run_port(w, x, 4, boundary, None)
    assert plan.backend != "fused_matmul"
    assert "fused_matmul" not in plan.decision.candidates
    modes = tuple(plan.boundary)
    check_decision(plan, 4, modes)
    assert f"boundary={'×'.join(modes)}" in plan.decision.reason
    np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 4))


# ---------------------------------------------------------------------------
# The periodic pin: one cache entry, unchanged results and reason strings
# ---------------------------------------------------------------------------
def test_periodic_spellings_share_one_plan_bitwise():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    grid = (64, 128)
    keys = {tplan.plan_signature(w, grid, torch.float32, 2, boundary=b,
                                 device="cpu")[0]
            for b in (None, "periodic", ("periodic", "periodic"),
                      (None, "periodic"))}
    assert len(keys) == 1
    p0 = tk.stencil_plan(w, grid, torch.float32, 2, device="cpu")
    p1 = tk.stencil_plan(w, grid, torch.float32, 2, boundary="periodic",
                         device="cpu")
    assert p1 is p0
    x = torch.from_numpy(_case("box", 1, grid, 2, None)[1])
    assert torch.equal(p0(x), p1(x))
    assert torch.equal(t_direct.stencil_direct_plain(x, w, 2),
                       t_direct.stencil_direct_plain(x, w, 2, "periodic"))


@pytest.mark.parametrize("shape", [(40, 67), (6, 20, 37), (67,)])
def test_plain_tap_sum_is_the_periodic_rolls_bitwise(shape):
    # On a periodic grid the padded slices hold torch.roll's values, in
    # the same accumulation order, so the plain version is bitwise the
    # roll formulation it had before boundaries.
    w = np.asarray(make_weights(JSpec("box", len(shape), 1), seed=0),
                   np.float32)
    x = torch.from_numpy(_case("box", 1, shape, 2, None)[1])
    cur = x
    for _ in range(2):
        acc = torch.zeros_like(cur)
        for *off, wv in t_direct.nonzero_taps(w):
            acc = acc + wv * torch.roll(cur, shifts=tuple(1 - o for o in off),
                                        dims=tuple(range(len(shape))))
        cur = acc
    assert torch.equal(t_direct.stencil_direct_plain(x, w, 2), cur)


def test_nonperiodic_keys_distinct():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    keys = {tplan.plan_signature(w, (64, 128), torch.float32, 2, boundary=b,
                                 device="cpu")[0]
            for b in [None, "zero", "reflect", "replicate",
                      ("reflect", "periodic"), ("periodic", "reflect")]}
    assert len(keys) == 6


def test_reason_string_only_changes_when_nonperiodic():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    base = tk.explain(w, 2, grid_shape=(256, 512))
    assert base.reason == tk.explain(w, 2, grid_shape=(256, 512),
                                     boundary="periodic").reason
    assert "boundary=" not in base.reason
    refl = tk.explain(w, 2, grid_shape=(256, 512),
                      boundary=("reflect", "periodic"))
    assert "boundary=reflect×periodic" in refl.reason
    jrefl = j_explain(w, 2, hw=J_H100, tile_n=16, strip_m=64, h_block=2,
                      w_tile=64, w_block=2, boundary=("reflect", "periodic"))
    assert refl.reason == jrefl.reason


def test_explain_lists_boundary_line():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    p = tk.stencil_plan(w, (64, 128), torch.float32, 2, device="cpu",
                        boundary=("reflect", "periodic"))
    assert "boundary : reflect×periodic" in p.explain()
    p0 = tk.stencil_plan(w, (64, 128), torch.float32, 2, device="cpu")
    assert "boundary" not in p0.explain()


# ---------------------------------------------------------------------------
# Both packages reject the same grids with the same messages
# (TestValidationErrorPaths, through each package)
# ---------------------------------------------------------------------------
def test_wrap_radius_and_reflect_extent_messages():
    jc = importlib.import_module("repro.kernels.common")
    for mod in (common, jc):
        mod._check_wrap_radius(2, 2, "periodic")
        with pytest.raises(ValueError, match="wrap radius .* lower the"):
            mod._check_wrap_radius(1, 2, "periodic")
        for mode in ("zero", "reflect", "replicate"):
            with pytest.raises(ValueError, match=f"whole {mode!r} axis"):
                mod._check_wrap_radius(2, 2, mode)
            mod._check_wrap_radius(3, 2, mode)
        with pytest.raises(ValueError, match="mirror cells"):
            mod._check_reflect_extent(2, 2, "x", "reflect")
        mod._check_reflect_extent(3, 2, "x", "reflect")
        mod._check_reflect_extent(2, 2, "x", "zero")


@pytest.mark.parametrize("shape,t,backend,boundary,match", [
    ((2,), 1, "direct", "zero", "whole 'zero' axis"),
    # the fused halo t*r binds reflect: extent 4 > r=2 but < 5
    ((4,), 2, "fused_direct", "reflect", "mirror cells"),
    ((64, 2), 1, "direct", ("periodic", "replicate"),
     "whole 'replicate' axis")])
def test_plans_reject_the_same_grids(shape, t, backend, boundary, match):
    w = make_weights(JSpec("box", len(shape), 2), seed=0)
    with pytest.raises(ValueError, match=match):
        tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                        boundary=boundary, device="cpu")
    with pytest.raises(ValueError, match=match):
        j_stencil_plan(w, shape, np.float32, t, backend=backend,
                       boundary=boundary, interpret=True)


@pytest.mark.parametrize("shape,r,t,boundary,match", [
    # JAX validate_tiling(shape, strip_m, tile_n, halo=t*r, radius=r)
    ((2, 128), 1, 2, ("reflect", "periodic"), "mirror cells"),
    ((2, 128), 1, 2, None, None),
    ((2, 64, 128), 2, 1, ("replicate", "periodic", "periodic"),
     "whole 'replicate' axis"),
    ((2, 64, 128), 1, 2, ("reflect", "periodic", "periodic"),
     "mirror cells"),
    ((2, 64, 128), 2, 1, None, None)])
def test_argument_rule_rejects_what_validate_tiling_rejects(shape, r, t,
                                                            boundary, match):
    w = make_weights(JSpec("box", len(shape), r), seed=0)
    strip = shape[-2]
    jv = functools.partial(validate_tiling, shape, strip, shape[-1], t * r,
                           radius=r, boundary=boundary)
    tv = functools.partial(common.check_grid, shape, w, t, boundary, "test")
    x = torch.zeros(shape)
    for fn in (jv, tv, lambda: t_direct.stencil_direct(x, w, t, boundary=boundary),
               lambda: t_matmul.stencil_matmul(x, w, t, boundary=boundary)):
        ctx = (pytest.raises(ValueError, match=match) if match
               else contextlib.nullcontext())
        with ctx:
            fn()


# ---------------------------------------------------------------------------
# Ragged and shallow tiles: the wrappers on a pinned tile, and the kernels'
# own tile-by-tile fill, emulated on the CPU
# ---------------------------------------------------------------------------
def _fill_axis(reg, ax, g0, n, o, mode):
    """csrc/common.cuh::fill_axis on a numpy region: region cell q along
    ``ax`` is global cell g0 + q of an axis of extent n; the cells below
    the domain and those above it within depth o are rebuilt from the
    line's in-domain cells, the deeper ones left as they are."""
    lines = np.moveaxis(reg, ax, 0)
    lo, hb, he = min(reg.shape[ax], max(0, -g0)), n - g0, \
        min(reg.shape[ax], n + o - g0)
    for q in itertools.chain(range(lo), range(hb, he)):
        g = g0 + q
        if mode == "zero":
            lines[q] = 0.0
        else:
            gs = ((0 if g < 0 else n - 1) if mode == "replicate"
                  else (-g if g < 0 else 2 * (n - 1) - g))
            lines[q] = lines[gs - g0]


def emulate_tap_sum(x, w, t, geom, modes):
    """The tap-sum kernels' dataflow on the CPU, CTA by CTA, as the CUDA
    runs it: the (T + 2h)^d region by modulo indices -- with every
    out-of-domain cell of a non-periodic axis set to NaN, so a cell the
    fill misses and a valid output reads shows -- then per step the fill
    at depth (t-s)r with the region's origin at tile origin - (t-s)r, a
    shrinking valid correlation (zero taps skipped), and the masked store.
    1D grids run on the (1, N) view with the lifted kernel and modes."""
    if x.ndim == 1:
        return emulate_tap_sum(x[None], common.lift_weights(w), t, geom,
                               common.lift_boundary_1d(modes))[0]
    r, dim = (w.shape[0] - 1) // 2, x.ndim
    h = t * r
    tiles = ((geom.z_slab,) if dim == 3 else ()) + (geom.strip_m,
                                                     geom.w_tile)
    taps = [(off, float(w[off])) for off in np.ndindex(*w.shape) if w[off]]
    y = np.full_like(x, np.nan)
    for org in itertools.product(*(range(0, n, tl) for n, tl in
                                   zip(x.shape, tiles))):
        reg = x[np.ix_(*(np.arange(a - h, a + tl + h) % n for a, tl, n in
                         zip(org, tiles, x.shape)))].astype(np.float32)
        for ax, (a, tl, n) in enumerate(zip(org, tiles, x.shape)):
            if modes[ax] != "periodic":
                g = np.arange(a - h, a + tl + h)
                np.moveaxis(reg, ax, 0)[(g < 0) | (g >= n)] = np.nan
        for s in range(t):
            o = (t - s) * r
            for ax, (a, n) in enumerate(zip(org, x.shape)):
                if modes[ax] != "periodic":
                    _fill_axis(reg, ax, a - o, n, o, modes[ax])
            out = np.zeros(tuple(m - 2 * r for m in reg.shape), np.float32)
            for off, wv in taps:
                out += wv * reg[tuple(slice(d, d + m) for d, m in
                                      zip(off, out.shape))]
            reg = out
        dst = tuple(slice(a, min(a + tl, n)) for a, tl, n in
                    zip(org, tiles, x.shape))
        y[dst] = reg[tuple(slice(0, d.stop - d.start) for d in dst)]
    return y


TILE_CASES = [
    # ragged: 16x16 tiles on 40x67 (the last column tile holds 3 columns)
    ((40, 67), "box", 2, 2, ("reflect", "replicate"), dict(tile_m=16,
                                                            w_tile=16)),
    ((40, 67), "star", 1, 4, ("zero", "reflect"), dict(tile_m=16,
                                                        w_tile=16)),
    # 3D, ragged on every axis: the rule's tile at h = 8 is 6 deep
    ((6, 20, 37), "box", 2, 4, ("replicate", "reflect", "periodic"), {}),
    ((12, 20, 37), "star", 1, 4, ("zero", "replicate", "reflect"), {}),
    # the 1D lift: 16-row tiles, one valid row, ragged width
    ((67,), "box", 1, 4, ("reflect",), dict(w_tile=16)),
    ((67,), "star", 2, 2, ("zero",), dict(w_tile=16)),
]


@pytest.mark.parametrize("shape,kind,r,t,boundary,pins", TILE_CASES)
def test_ragged_and_shallow_tiles(shape, kind, r, t, boundary, pins):
    w, x, ref = _case(kind, r, shape, t, boundary)
    geom = common.launch_geom(shape, t * r, **pins)
    if shape == (6, 20, 37):
        assert geom.z_slab < t * r                   # shallower than h
    xt = torch.from_numpy(x)
    tol = tolerance(x, t)
    for y in (t_direct.stencil_direct_at(xt, w, t, geom, boundary),
              t_matmul.stencil_matmul_at(xt, w, t, geom, None, boundary)):
        np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=tol)
    emu = emulate_tap_sum(x, np.asarray(w, np.float32), t, geom,
                          common.check_grid(shape, w, t, boundary, "emu")[1])
    assert np.isfinite(emu).all()
    np.testing.assert_allclose(emu, ref, rtol=0, atol=tol)


def test_emulated_fill_is_the_periodic_load_when_periodic():
    # the emulation is exact on a periodic grid too (no fill runs)
    w, x, ref = _case("box", 1, (40, 67), 3, None)
    geom = common.launch_geom((40, 67), 3, tile_m=16, w_tile=16)
    np.testing.assert_allclose(
        emulate_tap_sum(x, np.asarray(w, np.float32), 3, geom,
                        ("periodic",) * 2), ref, rtol=0, atol=tolerance(x, 3))


def test_zero_axis_shallower_than_the_halo_runs_where_jax_refuses():
    # A zero axis of extent between r+1 and t*r: the port's modulo loads
    # and per-step fills run it and match the oracle; the JAX strip
    # substrate needs strip_m >= t*r and refuses (ROADMAP queue 3).
    w, x, ref = _case("box", 1, (3, 40), 4, "zero")
    for backend in ("fused_direct", "fused_matmul_reuse"):
        _, y = run_port(w, x, 4, "zero", backend)
        np.testing.assert_allclose(y, ref, rtol=0, atol=tolerance(x, 4))
    geom = common.launch_geom((3, 40), 4)
    np.testing.assert_allclose(
        emulate_tap_sum(x, np.asarray(w, np.float32), 4, geom,
                        ("zero", "zero")), ref, rtol=0, atol=tolerance(x, 4))
    with pytest.raises(ValueError, match="exceeds strip height"):
        j_direct(jnp.asarray(x), w, 4, boundary="zero", interpret=True)


# ---------------------------------------------------------------------------
# Mode codes, and where the wrappers put them on the C launch call
# ---------------------------------------------------------------------------
def test_kernel_mode_codes():
    assert common.BOUNDARY_CODES == {"periodic": 0, "zero": 1, "reflect": 2,
                                     "replicate": 3}
    assert common.kernel_mode_codes(("reflect", "periodic")) == (2, 0)
    assert common.kernel_mode_codes(("replicate", "reflect", "zero")) == \
        (3, 2, 1)
    assert common.kernel_mode_codes(("zero",)) == (0, 1)      # the 1D lift
    assert common.lift_boundary_1d("reflect") == ("periodic", "reflect")
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           "common.cuh").read_text()
    for mode, code in common.BOUNDARY_CODES.items():
        assert f"#define MODE_{mode.upper()} {code}" in src


def _c_params(kernel: str, entry: str) -> list:
    """Parameter names of ``extern "C" int <entry>(...)`` in the source."""
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           f"{kernel}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    """Stands in for a kernel's C entry point: keeps the ctypes signature
    the wrapper sets and the arguments of the last call."""

    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("mod,shape,boundary", [
    ("direct", (40, 67), ("reflect", "periodic")),
    ("direct", (6, 20, 37), ("replicate", "reflect", "zero")),
    ("direct", (67,), ("zero",)),
    ("matmul", (40, 67), ("periodic", "zero")),
    ("matmul", (6, 20, 37), ("zero", "periodic", "replicate")),
    ("matmul", (67,), ("reflect",))])
def test_wrappers_pass_the_mode_codes_to_the_launchers(monkeypatch, mod,
                                                       shape, boundary):
    m = t_direct if mod == "direct" else t_matmul
    kernel = {"direct": "stencil_direct", "matmul": "stencil_banded"}[mod] \
        + ("3d" if len(shape) == 3 else "")
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake, "stencil_direct_threads": lambda r, smem: 256}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    launcher = m._launcher3d if len(shape) == 3 else m._launcher
    launcher.cache_clear()
    t_direct._threads.cache_clear()
    try:
        w = np.asarray(make_weights(JSpec("box", len(shape), 1), seed=0),
                       np.float32)
        x = torch.zeros(shape)
        geom = common.launch_geom(shape, 2)
        codes = common.kernel_mode_codes(boundary)
        # the launchers take (B,) + grid; the 1D lift's grid is (1, N)
        x2 = x.view(1, 1, -1) if len(shape) == 1 else x[None]
        w2 = common.lift_weights(w) if len(shape) == 1 else w
        launch = m._launch3d if len(shape) == 3 else m._launch2d
        if mod == "direct":
            launch(x2, w2, 2, 1, geom, codes)
        else:
            launch(x2, w2, 2, 1, torch.float32, geom, codes)
    finally:
        launcher.cache_clear()
        tk.reset_launch_counts()
    params = _c_params(kernel, f"{kernel}_launch")
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    names = ("mode_z", "mode_y", "mode_x")[-len(codes):]
    assert tuple(args[n] for n in names) == codes
    assert args["t"] == 2 and args["dtype"] == 0
    assert (args["B"], args["grid_elems"]) == (1, x.numel())
