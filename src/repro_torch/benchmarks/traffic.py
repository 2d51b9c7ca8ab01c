"""Substrate traffic benchmark (the counterpart of ``benchmarks/traffic.py``):
the seed 9-tile foil vs the whole-strip foil vs the port's own tile.

    PYTHONPATH=src python -m repro_torch.benchmarks.traffic [--quick] [--device cpu]

The paper's argument is that stencils are memory-bound, so the traffic a
scheme requests is the experiment.  The seed scheme reads nine whole
tiles per output tile (9x); the whole-strip foil the whole tiles above, at
and below its own, with the x-halo (2D 3(1 + 2h/TN)x, the 3D whole-slab
foil 9(1 + 2h/TN)x); the port's own tile (``common.resolve_tile_geom``,
the tile the fused plans launch on) reads its region once, walked by
``common.tile_windows``: (1 + 2h/TM)(1 + 2h/TN)x in 2D, with the planes'
factor in 3D, the read amplification the plans price.

For Box/Star x r in {1,2,3} x t in {1,2,4,8} (``BENCH_QUICK``: r = 1, t
in {1, 4}) this emits, per scheme:
  * windows loaded per output tile (9 vs 3 vs the tile's 1 region),
  * per-step read bytes (analytic; the banded operand on the MMA paths:
    the seed's bands per tile as the JAX model charges them, the port's
    Toeplitz rows per CTA),
  * microseconds per step of the plans (``stencil_plan``: build time
    recorded apart, ``plan_build_us_*``): on the card device time from
    CUDA events (``timing.time_us``); with ``--device cpu`` the plain
    versions' host wall time, which every row says (``timed_on``),
  * the compacted operand's structure: ``band_sparsity``,
    ``kept_row_fraction``, the MMA FLOPs per step dense and compacted
    (star < dense, box equal), and the compacted plan's output against the
    dense reuse plan's, bit for bit.

Then the 3D sweep (``cases_3d``: whole-slab foil vs the port's slab tile,
``common.hbm_read_bytes_per_step_3d`` on the port's geometry), the wide
grid (``cases_wide``: the whole-width foil, 3x, vs the port's column tile,
which every 2D launch takes), the boundary modes (``cases_boundary``:
the fused tap-sum and reuse plans under zero / reflect / replicate /
mixed specs against the oracle), and ``halo_overlap``: a two-rank world
(``repro_torch.launch.world``) timing the ``overlap`` stepper against the
serialized exchange (exchange, wait, compute per step), outputs bit for
bit, with the stepper's interleave counters.

Results land in ``BENCH_torch_kernels.json`` (``BENCH_torch_kernels.quick.json``
under ``BENCH_QUICK`` or ``--quick``) at the repository's root, both
gitignored; the JAX ``BENCH_kernels.json`` stays the JAX run's.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np
import torch

from repro_torch.benchmarks.timing import CaseTimeout, case_budget, time_us
from repro_torch.core import events as guard_events
from repro_torch.kernels import common, legacy, plan_cache_stats, stencil_plan
from repro_torch.kernels.ref import oracle_tolerance
from repro_torch.kernels.stencil_matmul import (band_sparsity, build_bands,
                                                build_bands_nd)
from repro_torch.kernels.stencil_sparse import (compact_bands,
                                                kept_row_fraction)
from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
from repro_torch.stencil.boundary import boundary_label, resolve_boundary
from repro_torch.stencil.reference import apply_stencil_steps

N = 128            # grid edge
TILE = 32          # the seed foil's tile edge (the JAX benchmark's strips)
SHAPES = ("box", "star")
RADII = (1, 2, 3)
DEPTHS = (1, 2, 4, 8)
QUICK_RADII = (1,)
QUICK_DEPTHS = (1, 4)
DTYPE_BYTES = 4
#: The 3D sweep: Box/Star-3D x r{1,2} x t{1,2} on the JAX sweep's grid.
N3 = (16, 32, 32)      # (Z, H, W)
TILE3 = 32             # the banded operand's chunk in the JAX model
CASES_3D = [(s, r, t) for s in SHAPES for r in (1, 2) for t in (1, 2)]
QUICK_CASES_3D = [("box", 1, 2), ("star", 1, 2)]
#: The wide-grid sweep: a grid 32 times as wide as tall, where a
#: whole-width strip would read 3x and the port's tile, as every 2D launch,
#: takes 64 columns at a time.
N_WIDE = (32, 1024)
CASES_WIDE = [("box", 1, 1), ("box", 1, 2), ("star", 1, 2)]
QUICK_CASES_WIDE = [("box", 1, 2)]
#: The boundary sweep: the fused tap-sum and reuse plans under each mode.
CASES_BOUNDARY = ["periodic", "zero", "reflect", "replicate",
                  ("reflect", "periodic")]
QUICK_CASES_BOUNDARY = ["periodic", "reflect"]
#: The overlap-vs-serialized pair: two ranks, rows sharded.
OVERLAP_GRID, OVERLAP_T = (256, 256), 4

ROOT = pathlib.Path(__file__).resolve().parents[3]
JSON_PATH = ROOT / "BENCH_torch_kernels.json"
JSON_PATH_QUICK = ROOT / "BENCH_torch_kernels.quick.json"


def tile_read_bytes(grid_shape, geom: common.SubstrateGeom,
                    dtype_bytes: int) -> int:
    """Bytes one launch on the port's tile reads: every CTA's read window
    (``common.tile_windows``, unwrapped), each cell once."""
    total = 0
    for w in common.tile_windows(grid_shape, geom):
        reads = w[len(grid_shape):]
        total += int(np.prod([b - a for a, b in reads]))
    return total * dtype_bytes


def windows_per_tile(grid_shape, geom: common.SubstrateGeom) -> float:
    """Read windows per CTA of the port's tile (its region: 1)."""
    wins = list(common.tile_windows(grid_shape, geom))
    return len(wins) / int(np.prod(common.launch_grid(grid_shape, geom)))


def toeplitz_bytes(grid_shape, geom: common.SubstrateGeom, w,
                   compute_bytes: int = DTYPE_BYTES) -> int:
    """The port's banded operand per launch: every CTA stages its bands'
    Toeplitz rows (kpad + 16 each, ``common.slab_fold_layout``)."""
    r = (np.asarray(w).shape[-1] - 1) // 2
    offsets, _ = build_bands_nd(np.asarray(w, np.float32), common.BAND_N)
    kpad = -(-(common.BAND_N + 2 * r) // common.mma_k_step(compute_bytes)) \
        * common.mma_k_step(compute_bytes)
    ctas = int(np.prod(common.launch_grid(grid_shape, geom)))
    return ctas * len(offsets) * (kpad + common.BAND_N) * compute_bytes


def mma_step_flops(w, tile_n: int, width: int, m_rows: int):
    """(dense, compacted) per-step MMA FLOPs of the radius-r banded
    contraction over the grid: the chunk walk of the JAX benchmark's
    ``_mxu_step_flops``, full-width chunks compacted to the packed band
    rows and remainder chunks dense."""
    offsets, bands = build_bands_nd(np.asarray(w, dtype=np.float32), tile_n)
    _, packed = compact_bands(offsets, bands)
    r = (bands.shape[1] - bands.shape[2]) // 2
    dense = sparse = 0
    start = 0
    while start < width:
        wcur = min(tile_n, width - start)
        d = len(offsets) * 2 * m_rows * wcur * (wcur + 2 * r)
        dense += d
        sparse += 2 * m_rows * wcur * packed.shape[0] if wcur == tile_n else d
        start += wcur
    return dense, sparse


def _time_us(plan, x, iters: int) -> float:
    """Microseconds per call of ``plan(x)``: CUDA events on the card; on
    the CPU the host clock around the plain versions (the best call)."""
    if x.device.type == "cuda":
        return time_us(plan, x, iters=iters)
    plan(x)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        plan(x)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _timed_on(device: str) -> str:
    return ("cuda: device time, CUDA events" if device == "cuda" else
            "cpu: host wall time of the plain versions, not a device time")


def _time_paths(row: dict, paths: dict, x, t: int, iters: int) -> None:
    for key, plan in paths.items():
        row[key] = _time_us(plan, x, iters) / t
        row[key.replace("us_step_", "plan_build_us_")] = \
            plan.build_time_s * 1e6


def _equal(a, b) -> bool:
    return bool(torch.equal(a, b))


def _tile_label(geom: common.SubstrateGeom) -> str:
    return "x".join(str(n) for n in (((geom.z_slab,) if geom.dim == 3
                                      else ()) + (geom.strip_m, geom.w_tile)))


def _case(shape: str, r: int, t: int, x, device: str, quick: bool) -> dict:
    spec = StencilSpec(shape, 2, r)
    w = make_weights(spec, seed=r)
    wf = fuse_weights(w, t)
    halo = r * t
    grid = (N, N)
    geom = common.launch_geom(grid, halo, need=common.tapsum_need(
        2, r, t, DTYPE_BYTES, "fused_direct"))
    bands_new = build_bands(w.astype(np.float32), TILE).shape
    bands_old = build_bands(wf.astype(np.float32), TILE).shape
    ops = toeplitz_bytes(grid, geom, w)
    row = {
        "case": f"{spec.name}-t{t}", "shape": shape, "r": r, "t": t,
        "boundary": "periodic", "tile": _tile_label(geom), "halo": halo,
        "loads_per_tile_old": len(legacy.NEIGHBOR_OFFSETS_2D),
        "loads_per_tile_new": common.STRIP_NEIGHBOR_LOADS,
        "loads_per_tile_tiled": windows_per_tile(grid, geom),
        "read_amp_new": common.staged_read_amp(geom, "wholestrip"),
        "read_amp_tiled": geom.read_amp,
        # one fused launch advances t steps: per-step read traffic
        "read_bytes_step_direct_old": legacy.hbm_read_bytes_per_step(
            grid, TILE, TILE, DTYPE_BYTES) / t,
        "read_bytes_step_direct_new": common.staged_read_bytes(
            grid, geom, "wholestrip", DTYPE_BYTES) / t,
        "read_bytes_step_direct_tiled": tile_read_bytes(
            grid, geom, DTYPE_BYTES) / t,
        "read_bytes_step_matmul_old": legacy.hbm_read_bytes_per_step(
            grid, TILE, TILE, DTYPE_BYTES, bands_shape=bands_old) / t,
        "read_bytes_step_matmul_new": (common.staged_read_bytes(
            grid, geom, "wholestrip", DTYPE_BYTES) + ops) / t,
        "read_bytes_step_matmul_tiled": (tile_read_bytes(
            grid, geom, DTYPE_BYTES) + ops) / t,
    }
    dense_f, sparse_f = mma_step_flops(w, TILE, N, N)
    row["band_sparsity"] = band_sparsity(w.astype(np.float32), TILE)
    row["kept_row_fraction"] = kept_row_fraction(w, TILE)
    row["mma_flops_step_dense"] = dense_f
    row["mma_flops_step_sparse"] = sparse_f
    dt = x.dtype
    pins = dict(device=device)
    paths = {
        "us_step_direct_old": stencil_plan(
            w, grid, dt, t, backend="legacy_direct", tile_m=TILE, w_tile=TILE,
            **pins),
        "us_step_direct_new": stencil_plan(
            w, grid, dt, t, backend="fused_direct_wholestrip", **pins),
        "us_step_direct_tiled": stencil_plan(
            w, grid, dt, t, backend="fused_direct", **pins),
        "us_step_matmul_old": stencil_plan(
            w, grid, dt, t, backend="legacy_matmul", tile_m=TILE, w_tile=TILE,
            **pins),
        "us_step_matmul_new": stencil_plan(
            w, grid, dt, t, backend="fused_matmul_reuse_wholestrip", **pins),
        "us_step_matmul_tiled": stencil_plan(
            w, grid, dt, t, backend="fused_matmul_reuse", **pins),
        "us_step_matmul_sparse": stencil_plan(
            w, grid, dt, t, backend="fused_sparse_matmul", **pins),
    }
    row["timed_on"] = _timed_on(device)
    _time_paths(row, paths, x, t, 2 if quick else 5)
    row["sparse_bitwise_equal"] = _equal(paths["us_step_matmul_sparse"](x),
                                         paths["us_step_matmul_tiled"](x))
    return row


def _case3d(shape: str, r: int, t: int, x3, device: str,
            quick: bool) -> dict:
    """One 3D case: the whole-slab foil vs the port's slab tile."""
    spec = StencilSpec(shape, 3, r)
    w = make_weights(spec, seed=r)
    halo = r * t
    geom = common.launch_geom(N3, halo, need=common.tapsum_need(
        3, r, t, DTYPE_BYTES, "fused_direct"))
    bands = build_bands_nd(w.astype(np.float32), TILE3)[1].shape
    ops = toeplitz_bytes(N3, geom, w)
    row = {
        "case": f"{spec.name}-t{t}", "shape": shape, "dim": 3, "r": r, "t": t,
        "boundary": "periodic", "tile": _tile_label(geom), "halo": halo,
        "loads_per_cell_wholestrip": 9,
        "loads_per_cell_tiled": windows_per_tile(N3, geom),
        "read_amp_wholestrip": common.staged_read_amp(geom, "wholestrip"),
        "read_amp_tiled": geom.read_amp,
        "read_bytes_step_direct_wholestrip": common.staged_read_bytes(
            N3, geom, "wholestrip", DTYPE_BYTES) / t,
        "read_bytes_step_direct_tiled": common.hbm_read_bytes_per_step_3d(
            N3, geom, DTYPE_BYTES) / t,
        "read_bytes_step_matmul_wholestrip": (common.staged_read_bytes(
            N3, geom, "wholestrip", DTYPE_BYTES) + ops) / t,
        "read_bytes_step_matmul_tiled": (common.hbm_read_bytes_per_step_3d(
            N3, geom, DTYPE_BYTES) + ops) / t,
        # the JAX model's per-tile band charge on the port's geometry
        "read_bytes_step_matmul_model": common.hbm_read_bytes_per_step_3d(
            N3, geom, DTYPE_BYTES, bands_shape=bands) / t,
    }
    dense_f, sparse_f = mma_step_flops(w, TILE3, N3[2], N3[0] * N3[1])
    row["band_sparsity"] = band_sparsity(w.astype(np.float32), TILE3)
    row["kept_row_fraction"] = kept_row_fraction(w, TILE3)
    row["mma_flops_step_dense"] = dense_f
    row["mma_flops_step_sparse"] = sparse_f
    dt = x3.dtype
    paths = {
        "us_step_direct_wholestrip": stencil_plan(
            w, N3, dt, t, backend="fused_direct_wholestrip", device=device),
        "us_step_direct_tiled": stencil_plan(
            w, N3, dt, t, backend="fused_direct", device=device),
        "us_step_matmul_wholestrip": stencil_plan(
            w, N3, dt, t, backend="fused_matmul_reuse_wholestrip",
            device=device),
        "us_step_matmul_tiled": stencil_plan(
            w, N3, dt, t, backend="fused_matmul_reuse", device=device),
        "us_step_matmul_sparse": stencil_plan(
            w, N3, dt, t, backend="fused_sparse_matmul", device=device),
    }
    row["timed_on"] = _timed_on(device)
    _time_paths(row, paths, x3, t, 1 if quick else 3)
    row["sparse_bitwise_equal"] = _equal(paths["us_step_matmul_sparse"](x3),
                                         paths["us_step_matmul_tiled"](x3))
    return row


def _case_wide(shape: str, r: int, t: int, xw, device: str,
               quick: bool) -> dict:
    """One wide-grid case: the whole-width 3-load foil (the JAX model's
    ``h_block = 0`` strip over the full width) vs the port's column tile,
    (1 + 2h/TM)(1 + 2h/TN)x."""
    spec = StencilSpec(shape, 2, r)
    w = make_weights(spec, seed=r)
    halo = r * t
    geom = common.launch_geom(N_WIDE, halo, need=common.tapsum_need(
        2, r, t, DTYPE_BYTES, "fused_direct"))
    row = {
        "case": f"{spec.name}-t{t}-wide", "shape": shape, "r": r, "t": t,
        "boundary": "periodic", "grid": list(N_WIDE),
        "smem_budget": common.smem_budget_bytes(),
        "strip_m": geom.strip_m, "h_block": geom.h_block,
        "w_tile": geom.w_tile, "w_block": geom.w_block,
        "read_amp_wholestrip": common.substrate_read_amp(geom.strip_m, 0),
        "read_amp_coltiled": geom.read_amp,
        "read_bytes_step_direct_wholestrip": common.hbm_read_bytes_per_step(
            N_WIDE, geom.strip_m, DTYPE_BYTES) / t,
        "read_bytes_step_direct_coltiled": tile_read_bytes(
            N_WIDE, geom, DTYPE_BYTES) / t,
        "read_bytes_step_matmul_coltiled": (tile_read_bytes(
            N_WIDE, geom, DTYPE_BYTES) + toeplitz_bytes(N_WIDE, geom, w)) / t,
    }
    dt = xw.dtype
    paths = {
        "us_step_direct_wholestrip": stencil_plan(
            w, N_WIDE, dt, t, backend="fused_direct_wholestrip",
            device=device),
        "us_step_direct_coltiled": stencil_plan(
            w, N_WIDE, dt, t, backend="fused_direct", device=device),
        "us_step_matmul_coltiled": stencil_plan(
            w, N_WIDE, dt, t, backend="fused_matmul_reuse", device=device),
    }
    row["timed_on"] = _timed_on(device)
    _time_paths(row, paths, xw, t, 1 if quick else 3)
    return row


def _case_boundary(mode, x, device: str, quick: bool) -> dict:
    """The fused tap-sum and reuse plans under one boundary spec, timed
    and held to the oracle (``apply_stencil_steps`` in f64) within
    ``oracle_tolerance``."""
    spec = StencilSpec("box", 2, 1)
    w = make_weights(spec, seed=1)
    t = 2
    modes = resolve_boundary(mode, 2)
    row = {"case": f"boundary-{boundary_label(modes)}", "shape": "box",
           "r": 1, "t": t, "boundary": boundary_label(modes)}
    backends = {"us_step_direct_tiled": "fused_direct",
                "us_step_matmul_tiled": "fused_matmul_reuse"}
    paths = {key: stencil_plan(w, x.shape, x.dtype, t, backend=b,
                               boundary=mode, device=device)
             for key, b in backends.items()}
    row["timed_on"] = _timed_on(device)
    _time_paths(row, paths, x, t, 2 if quick else 5)
    ref = apply_stencil_steps(x.cpu().double(), w.astype(np.float64), t,
                              modes)
    errs, tols = [], []
    for key, b in backends.items():
        y = paths[key](x).cpu().double()
        errs.append(float((y - ref).abs().max()))
        tols.append(oracle_tolerance(b, t, w, x.cpu()))
    row["oracle_max_err"] = max(errs)
    row["oracle_within_tol"] = all(e <= tl for e, tl in zip(errs, tols))
    row["oracle_tol"] = min(tols)
    return row


def overlap_rank(mesh, rank: int, grid, t: int, device: str) -> dict:
    """One rank of the overlap pair (``halo_overlap``): the ``overlap``
    stepper against the serialized-exchange foil on this rank's row
    shard, best of 5 calls each (host clock, ending in a synchronize on
    the card), and whether the two agree bit for bit."""
    from repro_torch.stencil.distributed import (apply_stencil_valid,
                                                 make_distributed_stepper,
                                                 overlap_stats,
                                                 reset_overlap_stats,
                                                 shard_of)
    dev = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=grid).astype(np.float32))
    dims = ("x", None)
    xl = shard_of(x, mesh, dims).to(dev)

    def serial_apply(xe, w_, steps):
        sync()                          # the exchange completes first
        for _ in range(steps):
            xe = apply_stencil_valid(xe, w_)
        return xe

    serialized = make_distributed_stepper(mesh, dims, w, t=t,
                                          mode="stepwise",
                                          local_apply=serial_apply)
    reset_overlap_stats()
    overlap = make_distributed_stepper(mesh, dims, w, t=t, mode="overlap")
    y_ser = serialized(xl)
    y_ov = overlap(xl)
    sync()
    stats = overlap_stats()

    def best_us(fn, iters: int = 5) -> float:
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(xl)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6

    return {"us_step_serialized": best_us(serialized) / t,
            "us_step_overlap": best_us(overlap) / t,
            "bitwise_equal": _equal(y_ser, y_ov),
            "interleave_counters": stats}


def _case_halo_overlap(device: str) -> dict:
    """The overlap-vs-serialized pair on a two-rank world (rows sharded),
    each rank's numbers side by side; the pair is bit for bit where every
    rank's is, and the overlap faster where it is on every rank."""
    from repro_torch.launch.world import run_world
    ranks = run_world(overlap_rank, 2, args=(OVERLAP_GRID, OVERLAP_T, device),
                      device=device)
    return {"case": "halo-overlap", "ranks": 2, "grid": list(OVERLAP_GRID),
            "t": OVERLAP_T, "r": 1, "timed_on": _timed_on(device) + (
                " (host clock around each call)" if device == "cuda" else ""),
            "us_step_serialized": max(r["us_step_serialized"] for r in ranks),
            "us_step_overlap": max(r["us_step_overlap"] for r in ranks),
            "overlap_faster": all(r["us_step_overlap"] < r["us_step_serialized"]
                                  for r in ranks),
            "bitwise_equal": all(r["bitwise_equal"] for r in ranks),
            "interleave_counters": ranks[0]["interleave_counters"],
            "per_rank": ranks}


def _budgeted(fn, label: str, *args) -> dict:
    """Run one case under the per-case wall-clock budget; a blown budget
    records a ``timed_out`` row instead of wedging the sweep."""
    try:
        with case_budget():
            return fn(*args)
    except CaseTimeout as e:
        print(f"traffic: case {label} timed out ({e}); continuing")
        return {"case": label, "timed_out": True, "error": str(e)}


def run(device: str = "cuda", quick: bool = False) -> list:
    """Run the sweeps on ``device`` (the trimmed sweep where ``quick`` or
    ``BENCH_QUICK`` is set), write the JSON and return the CSV lines."""
    quick = bool(quick) or bool(os.environ.get("BENCH_QUICK"))
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("traffic: no CUDA device; pass device='cpu' to "
                           "run the plain versions on the CPU")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32)).to(device)
    x3 = torch.from_numpy(rng.normal(size=N3).astype(np.float32)).to(device)
    radii = QUICK_RADII if quick else RADII
    depths = QUICK_DEPTHS if quick else DEPTHS
    rows = [_budgeted(_case, f"{shape}2d-r{r}-t{t}", shape, r, t, x, device,
                      quick)
            for shape in SHAPES for r in radii for t in depths]
    rows3d = [_budgeted(_case3d, f"{shape}3d-r{r}-t{t}", shape, r, t, x3,
                        device, quick)
              for shape, r, t in (QUICK_CASES_3D if quick else CASES_3D)]
    xw = torch.from_numpy(rng.normal(size=N_WIDE).astype(np.float32)).to(device)
    rows_wide = [_budgeted(_case_wide, f"{shape}2d-r{r}-t{t}-wide", shape, r,
                           t, xw, device, quick)
                 for shape, r, t in (QUICK_CASES_WIDE if quick
                                     else CASES_WIDE)]
    rows_boundary = [_budgeted(_case_boundary, f"boundary-{mode}", mode, x,
                               device, quick)
                     for mode in (QUICK_CASES_BOUNDARY if quick
                                  else CASES_BOUNDARY)]
    row_overlap = _budgeted(_case_halo_overlap, "halo-overlap", device)

    with open(JSON_PATH_QUICK if quick else JSON_PATH, "w") as f:
        json.dump({"grid": N, "seed_tile": TILE, "dtype_bytes": DTYPE_BYTES,
                   "quick": quick, "radii": list(radii),
                   "depths": list(depths), "grid_3d": list(N3),
                   "grid_wide": list(N_WIDE), "device": device,
                   "device_name": (torch.cuda.get_device_name(0)
                                   if device == "cuda" else "cpu"),
                   "timing": _timed_on(device),
                   "cases": rows, "cases_3d": rows3d,
                   "cases_wide": rows_wide,
                   "cases_boundary": rows_boundary,
                   "halo_overlap": row_overlap,
                   # the guard's record of the sweep: empty on a clean run
                   "guard_events": guard_events.snapshot(),
                   "plan_stats": plan_cache_stats()}, f, indent=1)
    return _lines(rows, rows3d, rows_wide, rows_boundary, row_overlap)


def _lines(rows, rows3d, rows_wide, rows_boundary, row_overlap) -> list:
    """The sweeps' CSV lines, each header naming its columns."""
    ok = [c for c in rows if not c.get("timed_out")]
    out = ["traffic.case,tile,loads_old/new/tiled,read_amp_new,"
           "read_amp_tiled,rdMB_step_mm_old,rdMB_step_mm_new,"
           "rdMB_step_mm_tiled,us_dir_old,us_dir_new,us_dir_tiled,"
           "us_mm_old,us_mm_new,us_mm_tiled,us_mm_sparse,kept_S,"
           "sparse_bitwise"]
    for c in ok:
        out.append(
            f"traffic.{c['case']},{c['tile']},{c['loads_per_tile_old']}/"
            f"{c['loads_per_tile_new']}/{c['loads_per_tile_tiled']:g},"
            f"{c['read_amp_new']:.2f}x,{c['read_amp_tiled']:.2f}x,"
            f"{c['read_bytes_step_matmul_old'] / 2**20:.3f},"
            f"{c['read_bytes_step_matmul_new'] / 2**20:.3f},"
            f"{c['read_bytes_step_matmul_tiled'] / 2**20:.3f},"
            f"{c['us_step_direct_old']:.0f},{c['us_step_direct_new']:.0f},"
            f"{c['us_step_direct_tiled']:.0f},"
            f"{c['us_step_matmul_old']:.0f},{c['us_step_matmul_new']:.0f},"
            f"{c['us_step_matmul_tiled']:.0f},"
            f"{c['us_step_matmul_sparse']:.0f},"
            f"{c['kept_row_fraction']:.4f},{c['sparse_bitwise_equal']}")
    out.append("traffic3d.case,tile,read_amp_whole,read_amp_tiled,"
               "rdMB_step_mm_whole,rdMB_step_mm_tiled,us_dir_whole,"
               "us_dir_tiled,us_mm_whole,us_mm_tiled,us_mm_sparse,kept_S,"
               "sparse_bitwise")
    for c in (c for c in rows3d if not c.get("timed_out")):
        out.append(
            f"traffic3d.{c['case']},{c['tile']},"
            f"{c['read_amp_wholestrip']:.2f}x,{c['read_amp_tiled']:.2f}x,"
            f"{c['read_bytes_step_matmul_wholestrip'] / 2**20:.3f},"
            f"{c['read_bytes_step_matmul_tiled'] / 2**20:.3f},"
            f"{c['us_step_direct_wholestrip']:.0f},"
            f"{c['us_step_direct_tiled']:.0f},"
            f"{c['us_step_matmul_wholestrip']:.0f},"
            f"{c['us_step_matmul_tiled']:.0f},"
            f"{c['us_step_matmul_sparse']:.0f},"
            f"{c['kept_row_fraction']:.4f},{c['sparse_bitwise_equal']}")
    out.append("trafficwide.case,w_tile/w_block,read_amp_whole,"
               "read_amp_coltiled,rdMB_step_dir_whole,rdMB_step_dir_col,"
               "us_dir_whole,us_dir_col,us_mm_col")
    for c in (c for c in rows_wide if not c.get("timed_out")):
        out.append(
            f"trafficwide.{c['case']},{c['w_tile']}/{c['w_block']},"
            f"{c['read_amp_wholestrip']:.2f}x,{c['read_amp_coltiled']:.2f}x,"
            f"{c['read_bytes_step_direct_wholestrip'] / 2**20:.3f},"
            f"{c['read_bytes_step_direct_coltiled'] / 2**20:.3f},"
            f"{c['us_step_direct_wholestrip']:.0f},"
            f"{c['us_step_direct_coltiled']:.0f},"
            f"{c['us_step_matmul_coltiled']:.0f}")
    out.append("trafficboundary.case,boundary,us_dir_tiled,us_mm_tiled,"
               "oracle_max_err,within_tol")
    for c in (c for c in rows_boundary if not c.get("timed_out")):
        out.append(
            f"trafficboundary.{c['case']},{c['boundary']},"
            f"{c['us_step_direct_tiled']:.0f},"
            f"{c['us_step_matmul_tiled']:.0f},"
            f"{c['oracle_max_err']:.2e},{c['oracle_within_tol']}")
    if "us_step_overlap" in row_overlap:
        c = row_overlap
        out.append("trafficoverlap.case,ranks,t,us_step_serialized,"
                   "us_step_overlap,overlap_faster,bitwise,"
                   "interior_before_recv")
        out.append(
            f"trafficoverlap.halo-overlap,{c['ranks']},{c['t']},"
            f"{c['us_step_serialized']:.0f},{c['us_step_overlap']:.0f},"
            f"{c['overlap_faster']},{c['bitwise_equal']},"
            f"{c['interleave_counters']['interior_before_recv_consumed']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.traffic")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print("\n".join(run(args.device, args.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
