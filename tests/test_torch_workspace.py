"""The layouts past one CTA and any thread-block cluster, in a device
workspace (the tile rule's fourth rung, ``common.WorkspaceLayout``), on
the CPU.

The workspace forms (the 2D and 3D tap-sum and fold sources built with
``-DREPRO_WORKSPACE``) build and run only on the card (``chip_smoke.py``
phase ``wide``, ``src/repro_torch/benchmarks/cluster_probe.py
workspace``).  Here: the fourth rung's tile and ``WorkspaceLayout`` on
the cells the rule refused before it (slice bytes, resident CTAs,
workspace bytes, no one-CTA or cluster layout on any candidate); every
tile the first three rungs pick, on every grid, pin and halo of
``test_torch_deep_tiles``'s frozen table, unchanged; a numpy emulation
of the workspace tap-sum's persistent walk (each CTA on its own slice of
one workspace, stale from its last tile, walking tiles c, c + P, ...)
against the one-CTA emulation bit for bit and JAX's oracle; the wrappers'
C launch arguments and counters on a fake card; and the explain line."""
import contextlib
import dataclasses
import importlib
import itertools
import pathlib
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.stencil.spec import StencilSpec  # noqa: E402
from repro_torch.stencil.weights import make_weights  # noqa: E402
import test_torch_deep_tiles as deep  # noqa: E402
import test_torch_tapsum3d_fold as tap3  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")
registry = importlib.import_module("repro_torch.kernels.registry")
t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")

CSRC = pathlib.Path(common.__file__).parent / "csrc"
BUDGET = common.SMEM_BUDGET_BYTES
CTAS = common.H100_SMS * common.WORKSPACE_CTAS_PER_SM

#: Cells the parent's rule refused ("too deep"): (pattern, t, regime).
REFUSED = [("Box-3D3R", 5, "fused_direct"), ("Box-3D3R", 8, "fused_direct"),
           ("Star-3D3R", 5, "fused_direct"), ("Box-3D4R", 4, "fused_direct"),
           ("Star-3D6R", 3, "fused_direct"), ("Box-3D7R", 2, "fused_direct"),
           ("Star-3D7R", 8, "fused_direct"),
           ("Box-3D4R", 6, "fused_matmul_reuse"),
           ("Box-3D5R", 3, "fused_matmul_reuse"),
           ("Box-3D7R", 2, "fused_matmul_reuse"),
           ("Star-3D7R", 8, "fused_matmul_reuse"),
           ("Star-3D4R", 6, "fused_sparse_matmul"),
           ("Box-3D6R", 3, "fused_sparse_matmul"),
           ("Star-3D7R", 2, "fused_sparse_matmul"),
           ("Box-3D3R", 8, "fused_matmul"), ("Box-3D7R", 4, "fused_matmul"),
           ("Box-2D7R", 16, "fused_direct"), ("Box-2D7R", 29, "fused_direct"),
           ("Box-2D7R", 16, "fused_matmul_reuse"),
           ("Box-2D7R", 29, "fused_matmul_reuse"),
           ("Box-2D7R", 16, "fused_sparse_matmul")]


def _cell(pattern, t, regime, shape, cdt=torch.float32):
    """``(need, weights, t, radius, layout_of)`` of the cell's one launch:
    its own layout (``TileNeed``) and, for a tile, the layout its wrapper
    launches with at the full budget."""
    spec = StencilSpec.from_name(pattern)
    w = make_weights(spec, seed=0)
    r = spec.radius
    dim = len(shape)
    if regime == "fused_direct":
        need = t_direct.tile_need(shape, r, t, torch.float32)
        if dim == 3:
            return need, w, t, r, lambda g: t_direct.direct3d_rings(g, r, t)
        return need, w, t, r, lambda g: t_direct.direct2d_layout(g, t * r)
    if regime == "fused_matmul":
        # a box composed t times is the full box of radius t r: the launch's
        # layout depends on its bands (every x-row), not on their values
        assert spec.shape == "box"
        w, r, t = np.ones((2 * t * r + 1,) * dim, np.float32), t * r, 1
    if regime == "fused_sparse_matmul":
        need = t_sparse.tile_need(shape, w, t, torch.float32, cdt)
        return need, w, t, r, lambda g: t_sparse.sparse_tile_layout(
            shape, w, t, g, cdt)
    need = t_matmul.tile_need(shape, w, t, torch.float32, cdt)
    if dim == 3:
        return need, w, t, r, lambda g: t_matmul.slab_launch_layout(
            g, r, t, cdt.itemsize, t_matmul.band_dzs(w), "3D banded")
    return need, w, t, r, lambda g: t_matmul.tile_launch_layout(
        g, r, t, cdt.itemsize, t_matmul.band_rows(w), "banded", deep=True)


@pytest.mark.parametrize("pattern,t,regime", REFUSED)
def test_the_fourth_rung_takes_the_refused_cells(pattern, t, regime):
    shape = (512, 512, 512) if "3D" in pattern else (1024, 1024)
    need, w, tk_, r, layout_of = _cell(pattern, t, regime, shape)
    halo = tk_ * r
    cands = common._candidates(shape, halo, None, None, None)
    # no candidate holds the layout on one CTA or over a cluster ...
    assert all(need.smem(*c) > BUDGET for c in cands)
    if need.cluster is not None:
        assert all(need.cluster(*c, BUDGET) is None for c in cands)
    # ... so the rule takes its first candidate, the least read
    # amplification, and the launch its workspace form
    geom = common.launch_geom(shape, halo, need=need)
    assert (geom.z_slab if geom.dim == 3 else 1, geom.strip_m,
            geom.w_tile) == cands[0]
    lay = layout_of(geom)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay == need.workspace(*cands[0])
    one = lay.base
    assert lay.ctas == CTAS == 264 and lay.smem_bytes == 0
    assert lay.slice_bytes % 128 == 0 and lay.total_bytes == CTAS * lay.slice_bytes
    if isinstance(one, common.SlabLayout):
        # the fold's slice: its region, then the band headers where the
        # one-CTA layout puts the Toeplitz rows, which stay in device memory
        region = -(-one.planes * one.plane_ld * 4 // 128) * 128
        assert lay.slice_bytes == -(-(region + one.n_rows * 16) // 128) * 128
        assert lay.slice_bytes < one.smem_bytes
    else:
        assert lay.slice_bytes == -(-one.smem_bytes // 128) * 128


def test_workspace_bytes_of_the_deepest_cells():
    # Box-3D7R at t = 8 on 512^3: the tap-sum's 129 ring slots of 176 x 184
    # floats (16 x 64 x 64 tile, h = 56), 264 slices: 4.2 GB of the card's
    # 80 GB; the composed contraction's 128-plane region and 12,769 headers
    shape = (512, 512, 512)
    need, *_ = _cell("Box-3D7R", 8, "fused_direct", shape)
    lay = need.workspace(16, 64, 64)
    assert (lay.base.slots, lay.base.rows, lay.base.ld) == (129, 176, 176)
    assert (lay.slice_bytes, lay.total_bytes) == (15985792, 4220249088)
    w = np.ones((33, 33, 33), np.float32)          # Box-3D2R composed 8 times
    lay = t_matmul.slab_launch_layout(common.SubstrateGeom(
        3, strip_m=64, h_block=16, z_slab=16, z_block=16, w_tile=64,
        w_block=16), 16, 1, 4, t_matmul.band_dzs(w), "3D banded", budget=1)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base.n_rows == 33 ** 2 and lay.base.kpad == 48


def test_a_budget_of_one_byte_forces_the_workspace_form():
    # the probes' and chip_smoke.py's forced launches: no CTA or cluster
    # holds any layout in one byte, on a tile one CTA holds
    geom = common.launch_geom((40, 72, 100), 4, need=t_direct.tile_need(
        (40, 72, 100), 1, 4, torch.float32))
    assert isinstance(t_direct.direct3d_rings(geom, 1, 4), common.Direct3dLayout)
    lay = t_direct.direct3d_rings(geom, 1, 4, budget=1)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base == common.direct3d_layout(geom.strip_m, geom.w_tile, 1, 4)
    g2 = common.launch_geom((256, 256), 4)
    assert isinstance(t_direct.direct2d_layout(g2, 4, budget=1),
                      common.WorkspaceLayout)
    # a foil has no workspace form: it raises past the 227 KB budget
    big = common.SubstrateGeom(3, strip_m=64, h_block=1, z_slab=16, z_block=1,
                               w_tile=64, w_block=1)
    dzs = (0, 0, 0, 1, 1, 1, 2, 2, 2)
    assert isinstance(t_matmul.slab_launch_layout(big, 1, 1, 4, dzs, "3D banded"),
                      common.WorkspaceLayout)
    with pytest.raises(ValueError, match="227 KB"):
        t_matmul.slab_launch_layout(big, 1, 1, 4, dzs, "3D banded",
                                    cluster=False, workspace=False)


def test_the_card_sizes_the_workspace_by_its_sms(monkeypatch):
    # a CUDA device's own SMs (here a 114-SM card); off the card, an H100's
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=114))
    card = torch.device("cuda", 0)
    lay = common.as_workspace(common.direct_layout(64, 64, 112), card)
    assert lay.ctas == 228 and lay.total_bytes == 228 * lay.slice_bytes
    off = common.as_workspace(common.direct_layout(64, 64, 112), "cpu")
    assert (off.ctas, off.slice_bytes) == (CTAS, lay.slice_bytes)
    # a plan resolves its launches' layout with its own device, the
    # function each launch resolves it with on the launch's device
    w = make_weights(StencilSpec.from_name("Box-3D7R"), seed=0)
    ctx = registry.PlanContext(
        spec=StencilSpec.from_name("Box-3D7R"), weights=w,
        grid_shape=(64, 64, 64), dtype=torch.float32, t=2, tile_m=None,
        w_tile=None, device=card)
    run = registry.get_backend("fused_direct").build(ctx)
    geom = ctx.launch_geom(w, 2, "direct", "fused_direct")
    assert run.workspace == t_direct.launch_layout((64, 64, 64), 7, 2, geom,
                                                   device=card)
    assert run.workspace.ctas == 228


@pytest.mark.parametrize("key", list(deep.TILES), ids=str)
def test_the_first_three_rungs_keep_their_tiles(key):
    # every tile the rule picks with the fourth rung is the one it picked
    # without it, wherever that built; where it refused, the fourth rung
    # takes the first candidate (a layout with a workspace form)
    grid, pins = key
    pins = dict(pins)
    halos = range(1, 33) if len(grid) == 2 else range(1, 10)
    for h in halos:
        cands = common._candidates(grid, h, pins.get("tile_m"),
                                   pins.get("w_tile"), pins.get("z_slab"))
        for need in deep._needs(grid, h):
            before = dataclasses.replace(need, workspace=None)
            try:
                want = common.resolve_tile_geom(grid, h, need=before, **pins)
            except ValueError:
                want = None
            if want is None and need.workspace is None:   # 1D: no fourth rung
                with pytest.raises(ValueError, match="too deep"):
                    common.resolve_tile_geom(grid, h, need=need, **pins)
                continue
            got = common.resolve_tile_geom(grid, h, need=need, **pins)
            if want is not None:
                assert got == want, (grid, pins, h, need.regime)
            else:
                assert (got.z_slab if got.dim == 3 else 1, got.strip_m,
                        got.w_tile) == cands[0], (grid, pins, h, need.regime)


# ---------------------------------------------------------------------------
# The workspace tap-sum's persistent walk, emulated
# ---------------------------------------------------------------------------
class _Slice:
    """CTA c's slice of one workspace array: ``tap3._Smem``'s interface at
    the slice's offset, every index checked against the slice's ends (so
    no CTA reaches another's slice), the values left from its last tile."""

    def __init__(self, ws, c, floats, nbytes):
        assert nbytes // 4 <= floats
        self.ws, self.off, self.n = ws, c * floats, nbytes // 4

    def take(self, idx):
        assert idx.min() >= 0 and idx.max() < self.n
        return self.ws[self.off + idx]

    def put(self, idx, vals):
        assert idx.min() >= 0 and idx.max() < self.n
        self.ws[self.off + idx] = vals


def emulate_workspace_tapsum3d(x, w, t, geom, modes, ctas, monkeypatch):
    """The workspace form of ``stencil_direct3d.cu`` on the CPU: ``ctas``
    persistent CTAs, CTA c on slice c of one workspace (NaN only before
    the first tile), walking the (tile, grid) items c, c + ctas, ...,
    tile i % tiles of grid i // tiles, x fastest; each item runs the
    one-CTA emulation's intervals on the CTA's slice.  Returns the output
    and the items each CTA ran."""
    b_, Z, H, W = x.shape
    r = (w.shape[0] - 1) // 2
    lay = common.as_workspace(common.direct3d_layout(
        geom.strip_m, geom.w_tile, r, t), None)
    floats = lay.slice_bytes // 4
    ws = np.full(ctas * floats, np.nan)
    gx, gy, gz = common.launch_grid((Z, H, W), geom)
    tiles = gx * gy * gz
    taps = [(dz, dy, dx, float(w[dz, dy, dx]))
            for dz, dy, dx in np.ndindex(*w.shape) if w[dz, dy, dx] != 0.0]
    one = common.direct3d_layout(geom.strip_m, geom.w_tile, r, t)
    h = t * r
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile

    def slot(s, q):
        i = q % one.ring0 if s == 0 else one.ring0 + (s - 1) * one.ring + q % one.ring
        return tap3.MARGIN + i * one.plane_ld

    y = np.full(x.shape, np.nan)
    ran = {c: [] for c in range(ctas)}
    current = {}
    monkeypatch.setattr(tap3, "_Smem", lambda nbytes: _Slice(
        ws, current["cta"], floats, nbytes))
    for rnd in itertools.count():
        live = [c + rnd * ctas for c in range(ctas) if c + rnd * ctas < b_ * tiles]
        if not live:
            break
        for item in live:                       # the CTAs of one round
            c = item % ctas
            current["cta"] = c
            b, tile = divmod(item, tiles)
            bx, by, bz = tile % gx, (tile // gx) % gy, tile // (gx * gy)
            ran[c].append(item)
            tap3._cta(x[b], y[b], b * Z * H * W, taps, r, t, bz * tz, by * tm,
                      bx * tn, tz, tm, tn, tz + 2 * h, tm + 2 * h, tn + 2 * h,
                      one.ld, one.lead, one, slot, modes[0] != "periodic", modes,
                      "region", None, tiles, geom)
    return y, ran


@pytest.mark.parametrize("kind,r,t,boundary,ctas", [
    ("box", 1, 4, None, 3), ("star", 2, 3, ("replicate", "reflect", "periodic"), 5),
    ("box", 3, 2, ("zero", "zero", "reflect"), 2), ("star", 5, 1, None, 4)])
def test_the_persistent_walk_equals_the_one_cta_kernel(kind, r, t, boundary, ctas,
                                                       monkeypatch):
    # two grids of a ragged 12 x 20 x 24 grid on 8 x 16 x 16 tiles (2 x 2 x
    # 2): every (tile, grid) item runs once, on CTA item % ctas, in order;
    # bit for bit (float64 here) the one-CTA emulation, within f32 of JAX
    shape = (12, 20, 24)
    w = tap3._weights(kind, r)
    x = np.stack([tap3._grid(shape, 7), tap3._grid(shape, 8)])
    modes = tuple(tap3.resolve_boundary(boundary, 3))
    geom = common.SubstrateGeom(3, strip_m=16, h_block=t * r, z_slab=8,
                                z_block=t * r, w_tile=16, w_block=t * r)
    one = tap3.emulate_tapsum3d(x, w, t, geom, modes)
    y, ran = emulate_workspace_tapsum3d(x, w, t, geom, modes, ctas, monkeypatch)
    items = sorted(i for v in ran.values() for i in v)
    assert items == list(range(2 * 8))
    assert all(v == list(range(c, 16, ctas)) for c, v in ran.items())
    np.testing.assert_array_equal(y, one)
    want = tap3._jax(shape, kind, r, t, boundary, 7)
    np.testing.assert_allclose(y[0], want, rtol=0, atol=tap3._tol(x[0], w, t))


# ---------------------------------------------------------------------------
# The sources, the builds and the C launch arguments
# ---------------------------------------------------------------------------
def _c_params(src: str, entry: str) -> list:
    text = (CSRC / src).read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


def test_the_workspace_forms_build_apart():
    cc = (CSRC / "common.cuh").read_text()
    assert int(re.search(r"#define WORKSPACE_MIN_BLOCKS (\d+)", cc).group(1)) == \
        common.WORKSPACE_CTAS_PER_SM
    assert len(_build.KERNELS) == 22 and len(set(_build.KERNELS)) == 22
    for name in _build.WORKSPACED:
        lib = f"{name}_workspace"
        assert lib in _build.KERNELS and _build.source(lib) == name
        assert "-DREPRO_WORKSPACE" in _build._flags(lib)
        assert "-DREPRO_WORKSPACE" not in _build._flags(name)
        assert f"{name} (workspace)" in _build.COUNTERS
        src = (CSRC / f"{name}.cu").read_text()
        params = _c_params(f"{name}.cu", f"{lib}_launch")
        main = _c_params(f"{name}.cu", f"{name}_launch")
        # the main entry's arguments, then the workspace's, then the batch's
        assert params[:len(main) - 4] == main[:-4]
        assert params[len(main) - 4:] == ["ws", "slice_bytes", "ctas"] + main[-4:]
        assert src.count("REPRO_WORKSPACE") >= 1
    # the folds' Toeplitz rows stay in device memory: the workspace build
    # stages the headers only and rounds the rows at the B load
    slab = (CSRC / "slab_fold.cuh").read_text()
    assert "#ifndef REPRO_WORKSPACE\n    const TC* src = static_cast<const TC*>(a.toe);" \
        in slab
    assert "b[0] = __float_as_uint(round(t[q]));" in slab


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    fake, other = _FakeLaunch(), _FakeLaunch()
    fake.other = other
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake if name.endswith("_workspace") else other,
           "stencil_direct_threads": lambda r, smem: 256}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    allocated = []

    def allocate(device, nbytes):
        allocated.append(nbytes)
        return torch.empty(nbytes if nbytes < 2 ** 20 else 0, dtype=torch.uint8)
    monkeypatch.setattr(common, "allocate_workspace", allocate)
    fake.allocated = allocated

    def clear():
        for mod in (t_direct, t_matmul, t_sparse):
            for name in ("_workspace_launcher", "_workspace_launcher3d",
                         "_launcher", "_launcher3d", "_cluster_launcher3d", "_threads"):
                if hasattr(getattr(mod, name, None), "cache_clear"):
                    getattr(mod, name).cache_clear()
        tk.reset_launch_counts()
    clear()
    yield fake
    clear()


@pytest.mark.parametrize("pattern,t,regime", [
    ("Box-3D3R", 5, "fused_direct"), ("Box-3D5R", 3, "fused_matmul_reuse"),
    ("Star-3D6R", 3, "fused_sparse_matmul"), ("Box-3D3R", 8, "fused_matmul"),
    ("Box-2D7R", 16, "fused_direct"), ("Box-2D7R", 16, "fused_matmul_reuse"),
    ("Box-2D7R", 16, "fused_sparse_matmul")])
@pytest.mark.parametrize("batch", [1, 2])
def test_wrapper_passes_the_workspace(fake_card, pattern, t, regime, batch):
    dim = 3 if "3D" in pattern else 2
    shape = (64, 64, 64) if dim == 3 else (256, 256)
    need, w, tk_, r, layout_of = _cell(pattern, t, regime, shape)
    geom = common.launch_geom(shape, tk_ * r, need=need)
    lay = layout_of(geom)
    assert isinstance(lay, common.WorkspaceLayout)
    w = np.asarray(w, np.float32)
    x = torch.zeros((batch,) + shape)
    codes = (1, 2, 0)[-dim:]
    sfx = "3d" if dim == 3 else ""
    if regime == "fused_direct":
        lib = f"stencil_direct{sfx}"
        launch = t_direct._launch3d if dim == 3 else t_direct._launch2d
        y = launch(x, w, tk_, r, geom, codes)
    else:
        lib = f"stencil_{'sparse' if 'sparse' in regime else 'banded'}{sfx}"
        mod = t_sparse if "sparse" in regime else t_matmul
        launch = mod._launch3d if dim == 3 else mod._launch2d
        y = launch(x, w, tk_, r, torch.float32, geom, codes)
    assert y.shape == x.shape and fake_card.other.args is None
    assert {k: v for k, v in tk.launch_counts().items() if v} == \
        {f"{lib} (workspace)": 1}
    assert fake_card.allocated == [lay.total_bytes]
    params = _c_params(f"{lib}.cu", f"{lib}_workspace_launch")
    assert len(fake_card.args) == len(params) == len(fake_card.argtypes)
    args = dict(zip(params, fake_card.args))
    assert args["H"] == shape[-2] and args["W"] == shape[-1]
    assert (args["TM"], args["TN"]) == (geom.strip_m, geom.w_tile)
    assert (args["slice_bytes"], args["ctas"]) == (lay.slice_bytes, lay.ctas)
    assert (args["smem_bytes"], args["B"], args["ld"]) == (0, batch, lay.base.ld)
    assert (args["mode_y"], args["mode_x"]) == codes[-2:]
    if dim == 3:
        assert (args["Z"], args["TZ"], args["mode_z"]) == (shape[0], geom.z_slab, 1)


def test_a_plan_keeps_its_workspace_and_explains_it(fake_card):
    # a plan keeps its workspace layout, named in explain(); every launch
    # allocates the workspace anew (the caching allocator reuses the
    # block), so no plan holds device memory between calls
    w = make_weights(StencilSpec.from_name("Box-3D7R"), seed=0)
    plan = tk.stencil_plan(w, (64, 64, 64), torch.float32, 2,
                           backend="fused_direct", device="cpu", use_cache=False)
    lay = plan.fn.workspace
    assert isinstance(lay, common.WorkspaceLayout)
    assert f"workspace: {lay.total_bytes} bytes" in plan.explain()
    x = torch.zeros((1, 64, 64, 64))
    geom = plan.ctx.launch_geom(w, 2, "direct", "fused_direct")
    for _ in range(2):
        t_direct._launch3d(x, np.asarray(w, np.float32), 2, 7, geom, (0, 0, 0))
    assert fake_card.allocated == [lay.total_bytes] * 2
    assert tk.launch_counts()["stencil_direct3d (workspace)"] == 2
    # a plan one CTA holds has none
    small = tk.stencil_plan(w, (64, 64, 64), torch.float32, 1,
                            backend="fused_direct", device="cpu", use_cache=False)
    assert small.fn.workspace is None and "workspace" not in small.explain()


def test_the_workspace_raises_past_free_memory(monkeypatch):
    # ... as the guard's memory class, so a guarded plan moves down its
    # ladder as for any out-of-memory failure
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1000, 10 ** 10))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 24)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 0)
    with pytest.raises(ValueError, match="needs 4220249088 bytes of device "
                                         "memory, over the 1024 bytes free") as e:
        common.allocate_workspace(torch.device("cuda", 0), 4220249088)
    from repro_torch.kernels import guard
    assert isinstance(guard.classify_failure(e.value), guard.VmemOverflowError)
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        common.allocate_workspace(torch.device("cpu"), 16)
