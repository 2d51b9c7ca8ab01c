"""The port's substrate traffic benchmark (``repro_torch.benchmarks.traffic``,
the counterpart of ``benchmarks/traffic.py``) on the CPU.

Its analytic columns equal the JAX benchmark's pure functions on the same
inputs where the scheme is the same: the seed 9-tile foil's read bytes
(``legacy.hbm_read_bytes_per_step``), the JAX slab model on a geometry
(``hbm_read_bytes_per_step_3d``, the port's tile's here), the whole-width
strip's (``common.hbm_read_bytes_per_step``), ``band_sparsity`` and
``kept_row_fraction``, and the MMA FLOPs of the JAX benchmark's
``_mxu_step_flops``.  The port's own tile reads its region once: the
windows ``common.tile_windows`` walks hold read_amp times the grid.  Then
``run(device="cpu")`` at ``BENCH_QUICK`` sizes (the plain versions, host
time, which the rows say), its JSON and the invariants
``scripts/verify_torch.sh`` asserts."""
import importlib
import json
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import legacy as jlegacy  # noqa: E402
from repro.kernels.stencil_matmul import band_sparsity as j_sparsity  # noqa: E402
from repro.kernels.stencil_sparse import kept_row_fraction as j_kept  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch.benchmarks import traffic  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CASES = [(s, r, t) for s in ("box", "star") for r in (1, 2, 3) for t in (1, 2, 4, 8)]


def _jax_traffic():
    """The JAX benchmark module (``benchmarks/traffic.py``), imported from
    the repository's root, for its pure ``_mxu_step_flops``."""
    root = str(traffic.ROOT)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("benchmarks.traffic")


@pytest.mark.parametrize("shape,r,t", CASES)
def test_analytic_columns_equal_jax(shape, r, t):
    w = make_weights(JSpec(shape, 2, r), seed=r)
    grid = (traffic.N, traffic.N)
    assert traffic.legacy.hbm_read_bytes_per_step(grid, traffic.TILE, traffic.TILE, 4) \
        == jlegacy.hbm_read_bytes_per_step(grid, traffic.TILE, traffic.TILE, 4)
    bands = (2 * r + 1, traffic.TILE + 2 * r, traffic.TILE)
    assert traffic.legacy.hbm_read_bytes_per_step(
        grid, traffic.TILE, traffic.TILE, 4, bands_shape=bands) == \
        jlegacy.hbm_read_bytes_per_step(grid, traffic.TILE, traffic.TILE, 4,
                                        bands_shape=bands)
    assert traffic.band_sparsity(w.astype(np.float32), traffic.TILE) == \
        j_sparsity(w.astype(np.float32), traffic.TILE)
    assert traffic.kept_row_fraction(w, traffic.TILE) == j_kept(w, traffic.TILE)
    assert traffic.mma_step_flops(w, traffic.TILE, traffic.N, traffic.N) == \
        _jax_traffic()._mxu_step_flops(w, traffic.TILE, traffic.N, traffic.N)
    # the whole-width strip of the JAX model
    assert common.hbm_read_bytes_per_step(traffic.N_WIDE, 32, 4) == \
        jcommon.hbm_read_bytes_per_step(traffic.N_WIDE, 32, 4)


@pytest.mark.parametrize("shape,r,t", [(s, r, t) for s in ("box", "star")
                                       for r in (1, 2) for t in (1, 2)])
def test_3d_model_on_the_port_tile_equals_jax(shape, r, t):
    w = make_weights(JSpec(shape, 3, r), seed=r)
    geom = common.launch_geom(traffic.N3, r * t, need=common.tapsum_need(
        3, r, t, 4, "fused_direct"))
    kw = dict(strip_m=geom.strip_m, h_block=geom.h_block, z_slab=geom.z_slab,
              z_block=geom.z_block, w_tile=geom.w_tile, w_block=geom.w_block)
    jg = jcommon.SubstrateGeom(dim=3, **kw)
    bands = (len(w.reshape(-1, w.shape[-1])), traffic.TILE3 + 2 * r, traffic.TILE3)
    for b in (None, bands):
        assert common.hbm_read_bytes_per_step_3d(traffic.N3, geom, 4, b) == \
            jcommon.hbm_read_bytes_per_step_3d(traffic.N3, jg, 4, b)
    assert traffic.mma_step_flops(w, traffic.TILE3, traffic.N3[2],
                                  traffic.N3[0] * traffic.N3[1]) == \
        _jax_traffic()._mxu_step_flops(w, traffic.TILE3, traffic.N3[2],
                                       traffic.N3[0] * traffic.N3[1])


@pytest.mark.parametrize("grid,h", [((128, 128), 4), ((128, 128), 24),
                                    ((16, 32, 32), 2), ((32, 1024), 2)])
def test_the_port_tile_reads_its_region_once(grid, h):
    dim = len(grid)
    geom = common.launch_geom(grid, h, need=common.tapsum_need(
        dim, 1, h, 4, "fused_direct"))
    assert traffic.windows_per_tile(grid, geom) == 1
    cells = int(np.prod(grid))
    assert traffic.tile_read_bytes(grid, geom, 4) == pytest.approx(
        geom.read_amp * cells * 4)


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory, monkeypatch_module):
    out = tmp_path_factory.mktemp("traffic")
    monkeypatch_module.setattr(traffic, "JSON_PATH_QUICK", out / "quick.json")
    monkeypatch_module.setattr(traffic, "JSON_PATH", out / "full.json")
    lines = traffic.run(device="cpu", quick=True)
    with open(out / "quick.json") as f:
        return lines, json.load(f)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_quick_run_on_the_cpu(quick_run):
    lines, data = quick_run
    assert data["quick"] and data["device"] == "cpu"
    assert data["timing"].startswith("cpu") and "not a device time" in data["timing"]
    assert len(data["cases"]) == 2 * len(traffic.QUICK_RADII) * len(traffic.QUICK_DEPTHS)
    assert [c["case"] for c in data["cases_3d"]] == ["Box-3D1R-t2", "Star-3D1R-t2"]
    for c in data["cases"] + data["cases_3d"] + data["cases_wide"] + \
            data["cases_boundary"]:
        assert not c.get("timed_out") and c["timed_on"] == data["timing"]
    head = {ln.split(".")[0] for ln in lines}
    assert head == {"traffic", "traffic3d", "trafficwide", "trafficboundary",
                    "trafficoverlap"}


def test_quick_run_holds_the_verify_invariants(quick_run):
    _, data = quick_run
    for c in data["cases_3d"]:
        assert c["read_amp_tiled"] < c["read_amp_wholestrip"]
        assert c["read_bytes_step_direct_tiled"] < c["read_bytes_step_direct_wholestrip"]
    for c in data["cases"] + data["cases_3d"]:
        assert c["sparse_bitwise_equal"], c["case"]
        if c["shape"] == "star":
            assert c["mma_flops_step_sparse"] < c["mma_flops_step_dense"]
        else:
            assert c["mma_flops_step_sparse"] == c["mma_flops_step_dense"]
    for c in data["cases"]:
        assert c["read_amp_tiled"] < c["read_amp_new"] < 9
        assert c["read_bytes_step_direct_tiled"] < c["read_bytes_step_direct_new"] \
            < c["read_bytes_step_direct_old"]
    for c in data["cases_wide"]:
        assert c["read_amp_coltiled"] < c["read_amp_wholestrip"] == 3.0
    for c in data["cases_boundary"]:
        assert c["oracle_within_tol"], c
    ov = data["halo_overlap"]
    assert ov["bitwise_equal"] and ov["ranks"] == 2
    assert ov["interleave_counters"]["interior_before_recv_consumed"] > 0
    assert data["guard_events"]["events"] == []
    assert data["plan_stats"]["build_failures"] == 0
