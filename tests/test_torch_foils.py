"""The traffic foils against the JAX package: every foil backend
(``<regime>_wholestrip``, ``legacy_direct``, ``legacy_matmul``) through the
port's ``stencil_plan(..., device="cpu")`` against the same backend of the
JAX plan in interpret mode, the refusals of both packages, the registry's
names, units and ranks, and the foils' staging geometry as pure Python
(``common.foil_windows``: whole neighbour tiles that cover the halo, their
bytes, and the region the kernels keep of them)."""
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

from repro.kernels import legacy as jlegacy  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common, legacy  # noqa: E402
from repro_torch.kernels.common import SubstrateGeom  # noqa: E402
from repro_torch.stencil.weights import fuse_weights  # noqa: E402

from test_torch_plan import tolerance  # noqa: E402

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

WHOLESTRIP = ["direct_wholestrip", "fused_direct_wholestrip",
              "matmul_wholestrip", "fused_matmul_wholestrip",
              "fused_matmul_reuse_wholestrip"]
LEGACY = ["legacy_direct", "legacy_matmul"]
FOILS = WHOLESTRIP + LEGACY


def run_both(backend, kind, r, t, shape, boundary=None, dim=2):
    """The port's plan and the JAX plan of one backend on one grid; the
    seed 9-tile foils on 32 x 32 tiles, as the JAX package's own tests run
    them.  Returns the input, the port's plan and both outputs."""
    w = make_weights(JSpec(kind, dim, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    tiles = {}
    if backend in LEGACY:
        tiles = dict(tile_m=32, w_tile=32)
    plan = tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                           device="cpu", boundary=boundary, **tiles)
    port = plan(torch.from_numpy(x)).numpy()
    jtiles = {"tile_m": 32, "tile_n": 32} if tiles else {}
    jp = jplan.stencil_plan(w, shape, jnp.float32, t, backend=backend,
                            boundary=boundary, **jtiles)
    return x, plan, port, np.asarray(jp(jnp.asarray(x)))


@pytest.mark.parametrize("backend", FOILS)
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 2])
def test_foil_plan_matches_jax(backend, kind, r, t):
    # f32: XLA and torch form FMAs differently, 1e-5 * max|x| per step
    # (test_torch_plan.tolerance), for the tap-sum and banded foils alike
    shape = (64, 64) if backend in LEGACY else (32, 64)
    x, plan, port, ref = run_both(backend, kind, r, t, shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.float32, t, 1))
    # a foil computes what its regime computes: on the CPU, bit for bit
    base = {"legacy_direct": "fused_direct",
            "legacy_matmul": "fused_matmul"}.get(
        backend, backend[:-len("_wholestrip")])
    same = tk.stencil_plan(plan.weights, shape, torch.float32, t,
                           backend=base, device="cpu")(torch.from_numpy(x))
    assert torch.equal(torch.from_numpy(port), same)


@pytest.mark.parametrize("backend,case", [
    ("fused_direct_wholestrip", dict(shape=(32, 37))),
    ("fused_matmul_reuse_wholestrip", dict(shape=(32, 37))),
    ("fused_direct_wholestrip", dict(shape=(32, 64),
                                     boundary=("reflect", "periodic"))),
    ("fused_matmul_reuse_wholestrip", dict(shape=(32, 64), boundary="zero")),
    ("fused_direct_wholestrip", dict(shape=(8, 16, 32), dim=3)),
    ("fused_matmul_reuse_wholestrip", dict(shape=(8, 16, 32), dim=3)),
    ("direct_wholestrip", dict(shape=(8, 16, 32), dim=3,
                               boundary=("replicate", "reflect", "periodic"))),
])
def test_foil_plan_matches_jax_elsewhere(backend, case):
    # a ragged width, non-periodic boundaries, and the whole-slab foil at
    # a small depth (h = 2 <= its 8-deep tile); same tolerance
    t = 2
    x, plan, port, ref = run_both(backend, "box", 1, t, **case)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.float32, t, 1))
    assert "foil" in plan.explain()


@pytest.mark.parametrize("backend", ["direct_wholestrip",
                                     "fused_matmul_reuse_wholestrip"])
def test_1d_foil_is_the_default_lift(backend):
    # JAX's halo-0 "flat" kind: the 1D foil reads what the lift reads
    x, plan, port, ref = run_both(backend, "box", 1, 2, (100,), dim=1)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.float32, 2, 1))
    base = tk.stencil_plan(plan.weights, (100,), torch.float32, 2,
                           backend=backend[:-len("_wholestrip")],
                           device="cpu")(torch.from_numpy(x))
    assert torch.equal(torch.from_numpy(port), base)
    assert "the 1D lift" in plan.explain() and "read_amp=1.000x" in \
        plan.explain()


# ---------------------------------------------------------------------------
# Refusals: the same ValueErrors in both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", LEGACY)
@pytest.mark.parametrize("shape,kwargs,match", [
    ((8, 16, 32), {}, "seed 2D 9-tile foil"),
    ((64, 64), dict(boundary="zero"), "periodic-only foil"),
    ((64, 64), dict(tile=(24, 32)), "not divisible by tiles"),
    ((64, 64), dict(tile=(2, 2), t=4), "exceeds tile"),
])
def test_foil_refusals_match_jax(backend, shape, kwargs, match):
    kwargs = dict(kwargs)
    t = kwargs.pop("t", 2)
    tm, tn = kwargs.pop("tile", (None, None))
    w = make_weights(JSpec("box", len(shape), 1), seed=0)
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jplan.stencil_plan(w, shape, jnp.float32, t, backend=backend,
                           tile_m=tm, tile_n=tn, **kwargs)(jnp.asarray(x))
    with pytest.raises(ValueError, match=match):
        xt = torch.from_numpy(x)
        if tm is None:
            tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                            device="cpu", **kwargs)(xt)
        elif backend == "legacy_direct":   # the plan's tile rule takes
            legacy.stencil_direct_9pt(xt, w, t, tm, tn)  # multiples of 16
        else:
            legacy.stencil_matmul_9pt(xt, fuse_weights(w, t), tm, tn)


def test_wholestrip_refuses_a_tile_shallower_than_the_halo():
    # the foil's three whole tiles must cover the halo (JAX's message)
    w = make_weights(JSpec("box", 2, 3), seed=0)
    with pytest.raises(ValueError, match="exceeds strip height"):
        tk.stencil_plan(w, (64, 64), torch.float32, 8,
                        backend="fused_direct_wholestrip", tile_m=16,
                        device="cpu")
    with pytest.raises(ValueError, match="exceeds strip height"):
        t_direct.stencil_direct_at(torch.zeros(64, 64), w, 8,
                                   common.launch_geom((64, 64), 24, 16),
                                   staging="wholestrip")


# ---------------------------------------------------------------------------
# The registry: every JAX name, unit and rank; foils never selected
# ---------------------------------------------------------------------------
def test_registry_has_every_jax_backend():
    assert set(tk.registered_backends()) == set(jreg.registered_backends())
    assert tk.registered_backends() == jreg.registered_backends()
    assert tk.fallback_ladder() == jreg.fallback_ladder()
    for name in tk.registered_backends():
        ours, theirs = tk.get_backend(name), jreg.get_backend(name)
        assert (ours.unit, ours.fallback_rank) == \
            (theirs.unit, theirs.fallback_rank), name
    for name in FOILS:
        assert tk.get_backend(name).price is None


@pytest.mark.parametrize("shape,t", [((8192, 8192), 4), ((8192, 8192), 1),
                                     ((512, 512, 512), 4), ((64, 64), 2)])
@pytest.mark.parametrize("sparse", [False, True])
def test_auto_never_selects_a_foil(shape, t, sparse):
    for kind in ("box", "star"):
        w = make_weights(JSpec(kind, len(shape), 1), seed=0)
        d = tk.explain(w, t, grid_shape=shape, use_sparse_unit=sparse)
        assert d.backend not in FOILS
        assert not set(d.candidates) & set(FOILS)


# ---------------------------------------------------------------------------
# Staging geometry as pure Python
# ---------------------------------------------------------------------------
def _gather(x, window):
    """The cells of an unwrapped window, read modulo the grid."""
    idx = [np.arange(lo, hi) % n for (lo, hi), n in zip(window, x.shape)]
    return x[np.ix_(*idx)]


def _emulate(x, geom, staging, cta):
    """csrc/common.cuh's staged load of one CTA in numpy: every cell of
    every window read, the region's cells kept at their region index,
    the others dropped (counted)."""
    outs, windows = cta
    h = geom.h_block
    origin = [lo - h for lo, _ in outs]
    size = [hi - lo for lo, hi in
            next(iter(common.foil_windows(x.shape, geom, "region")))[1][0]]
    region = np.full(size, np.nan)
    dropped = 0
    for win in windows:
        vals = _gather(x, win)
        for pos in itertools.product(*(range(hi - lo) for lo, hi in win)):
            q = tuple(lo + p - o for (lo, _), p, o in zip(win, pos, origin))
            if all(0 <= qq < n for qq, n in zip(q, size)):
                region[q] = vals[pos]
            else:
                dropped += 1
    return region, dropped


GEOMS = [
    ((40, 67), SubstrateGeom(2, strip_m=16, h_block=2, w_tile=32, w_block=2)),
    ((64, 64), SubstrateGeom(2, strip_m=32, h_block=3, w_tile=16, w_block=3)),
    ((6, 20, 37), SubstrateGeom(3, strip_m=16, h_block=2, z_slab=4,
                                z_block=2, w_tile=16, w_block=2)),
]


@pytest.mark.parametrize("shape,geom", GEOMS)
@pytest.mark.parametrize("staging", ["region", "wholestrip", "9tile"])
def test_foil_windows_are_whole_tiles_covering_the_region(shape, geom,
                                                          staging):
    if staging == "9tile" and len(shape) == 3:
        with pytest.raises(ValueError, match="2D grids only"):
            list(common.foil_windows(shape, geom, staging))
        return
    x = np.random.default_rng(0).normal(size=shape)
    h = geom.h_block
    tiles = ((geom.z_slab,) if len(shape) == 3 else ()) + (geom.strip_m,
                                                           geom.w_tile)
    ctas = list(common.foil_windows(shape, geom, staging))
    regions = list(common.foil_windows(shape, geom, "region"))
    assert [c[0] for c in ctas] == [c[0] for c in regions] == \
        [w[:len(shape)] for w in common.tile_windows(shape, geom)]
    cells = 0
    for cta, reg in zip(ctas, regions):
        outs, windows = cta
        want = _gather(x, reg[1][0])
        for win in windows:
            cells += int(np.prod([hi - lo for lo, hi in win]))
            extents = tuple(hi - lo for lo, hi in win)
            if staging == "wholestrip":        # whole tiles with the x-halo
                assert extents == tiles[:-1] + (tiles[-1] + 2 * h,)
            elif staging == "9tile":           # whole tiles
                assert extents == tiles
            # every window starts on a tile boundary of the leading axes
            if staging != "region":
                for (lo, _), n, (o, _) in zip(win[:-1], tiles, outs):
                    assert (lo - o) % n == 0
        got, dropped = _emulate(x, geom, staging, cta)
        np.testing.assert_array_equal(got, want)     # covers the region
        if staging == "region":
            assert dropped == 0
    amp = common.staged_read_amp(geom, staging)
    assert cells * 4 == common.staged_read_bytes(shape, geom, staging, 4)
    if staging != "region":
        assert amp == pytest.approx(
            {"wholestrip": 3 ** (len(shape) - 1) * (1 + 2 * h / tiles[-1]),
             "9tile": 9.0}[staging])


def test_assembly_rules_rebuild_the_region():
    # the JAX package's assemble_strip / _assemble_foil / assemble_extended
    # on the foils' whole tiles give the region the default kernel reads
    rng = np.random.default_rng(1)
    x2 = torch.from_numpy(rng.normal(size=(64, 96)))
    g2 = SubstrateGeom(2, strip_m=16, h_block=3, w_tile=32, w_block=3)
    for (outs, windows), (_, (reg,)) in zip(
            common.foil_windows(x2.shape, g2, "wholestrip"),
            common.foil_windows(x2.shape, g2, "region")):
        tiles = [torch.from_numpy(_gather(x2.numpy(), w)) for w in windows]
        assert torch.equal(common.assemble_strip(*tiles, 3),
                           torch.from_numpy(_gather(x2.numpy(), reg)))
    for (outs, windows), (_, (reg,)) in zip(
            common.foil_windows(x2.shape, g2, "9tile"),
            common.foil_windows(x2.shape, g2, "region")):
        tiles = [torch.from_numpy(_gather(x2.numpy(), w)) for w in windows]
        assert torch.equal(legacy.assemble_extended(tiles, 3),
                           torch.from_numpy(_gather(x2.numpy(), reg)))
    x3 = rng.normal(size=(8, 32, 40))
    g3 = SubstrateGeom(3, strip_m=16, h_block=2, z_slab=4, z_block=2,
                       w_tile=16, w_block=2)
    for (outs, windows), (_, (reg,)) in zip(
            common.foil_windows(x3.shape, g3, "wholestrip"),
            common.foil_windows(x3.shape, g3, "region")):
        tiles = [torch.from_numpy(_gather(x3, w)) for w in windows]
        assert torch.equal(common.assemble_foil(tiles, 2),
                           torch.from_numpy(_gather(x3, reg)))


@pytest.mark.parametrize("shape,tile,halo", [((256, 256), 32, 2),
                                             ((8192, 8192), 128, 4),
                                             ((64, 128), 32, 4)])
@pytest.mark.parametrize("bands", [None, (3, 40, 32)])
def test_legacy_bytes_equal_the_jax_count(shape, tile, halo, bands):
    geom = legacy.tile_geom(shape, tile, tile, halo)
    ours = legacy.hbm_read_bytes_per_step(shape, tile, tile, 4, bands)
    assert ours == jlegacy.hbm_read_bytes_per_step(shape, tile, tile, 4,
                                                   bands)
    if bands is None:
        assert ours == common.staged_read_bytes(shape, geom, "9tile", 4)
        assert ours == 9 * int(np.prod(shape)) * 4


def test_wholestrip_bytes_at_the_main_path_tiles():
    # 8192^2 at h = 4 on 64 x 64 tiles; 512^3 at h = 4 on 16 x 16 x 32
    g2 = common.launch_geom((8192, 8192), 4)
    assert common.staged_read_bytes((8192, 8192), g2, "wholestrip", 4) == \
        8192 * 8192 * 4 * 3 * 72 // 64
    assert common.staged_read_amp(g2, "wholestrip") == 3 * 72 / 64
    assert common.substrate_read_amp(g2.strip_m, 0) == 3.0
    g3 = common.launch_geom((512, 512, 512), 4)
    assert (g3.z_slab, g3.strip_m, g3.w_tile) == (16, 16, 32)
    assert common.staged_read_bytes((512,) * 3, g3, "wholestrip", 4) == \
        512 ** 3 * 4 * 9 * 40 // 32
    assert common.staged_read_bytes((512,) * 3, g3, "region", 4) == \
        512 ** 3 * 4 * 24 * 24 * 40 // (16 * 16 * 32)


# ---------------------------------------------------------------------------
# The foils' C launch interface
# ---------------------------------------------------------------------------
def _c_params(source: str, entry: str) -> list:
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("mod,shape,staging", [
    ("direct", (40, 67), "wholestrip"), ("direct", (64, 64), "9tile"),
    ("direct", (6, 20, 37), "wholestrip"),
    ("matmul", (40, 67), "wholestrip"), ("matmul", (64, 64), "9tile"),
    ("matmul", (6, 20, 37), "wholestrip")])
def test_foil_wrappers_pass_the_staging_code(monkeypatch, mod, shape,
                                             staging):
    m = t_direct if mod == "direct" else t_matmul
    source = {"direct": "stencil_direct", "matmul": "stencil_banded"}[mod] \
        + ("3d" if len(shape) == 3 else "")
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    launcher = m._foil_launcher3d if len(shape) == 3 else m._foil_launcher
    launcher.cache_clear()
    tk.reset_launch_counts()
    try:
        w = np.asarray(make_weights(JSpec("box", len(shape), 1), seed=0),
                       np.float32)
        geom = (legacy.tile_geom(shape, 32, 32, 2) if staging == "9tile"
                else common.launch_geom(shape, 2))
        codes = common.kernel_mode_codes(("periodic",) * len(shape))
        launch = m._launch3d if len(shape) == 3 else m._launch2d
        x = torch.zeros((1,) + shape)          # the launchers take a batch
        if mod == "direct":
            launch(x, w, 2, 1, geom, codes, staging)
        else:
            launch(x, w, 2, 1, torch.float32, geom, codes, staging)
    finally:
        launcher.cache_clear()
        counts = tk.launch_counts()
        tk.reset_launch_counts()
    counter = f"{source} ({'wholeslab' if len(shape) == 3 else staging})"
    assert counts[counter] == 1 and sum(counts.values()) == 1
    params = _c_params(source, f"{source}_foil_launch")
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    assert args["stage"] == common.STAGE_CODES[staging]
    assert (args["B"], args["grid_elems"]) == (1, x.numel())
    assert (args["TM"], args["TN"]) == (geom.strip_m, geom.w_tile)
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           "common.cuh").read_text()
    for name, code in (("REGION", 0), ("STRIP", 1), ("NINE", 2)):
        assert f"#define STAGE_{name} {code}" in src


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("count", [False, True])
def test_load_counting_builds_only_the_foils(monkeypatch, count):
    # REPRO_COUNT_LOADS=1 adds the counting define to every library's
    # build (the foils' and, since the auditor's witness, the default
    # kernels'), so the counting libraries build apart from the default
    # ones, whose flags stay as they were
    if count:
        monkeypatch.setenv("REPRO_COUNT_LOADS", "1")
    else:
        monkeypatch.delenv("REPRO_COUNT_LOADS", raising=False)
    for name in _build.KERNELS:
        flags = _build._flags(name)
        assert ("-DREPRO_FOIL" in flags) == name.endswith("_foil")
        assert ("-DREPRO_COUNT_LOADS" in flags) == count
        if not count:
            assert flags == _build.NVCC_FLAGS + (
                ("-DREPRO_FOIL",) if name.endswith("_foil") else ()) + (
                ("-DREPRO_CLUSTER",) if name.endswith("_cluster") else ()) + (
                ("-DREPRO_WORKSPACE",) if name.endswith("_workspace") else ())
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           "common.cuh").read_text()
    assert 'extern "C" int repro_load_counts(' in src
