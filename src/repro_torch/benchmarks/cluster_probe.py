"""A check of the 3D kernels' cluster forms, and of the 2D and 3D
kernels' workspace forms, on one card: build them, hold each cluster
launch to the one-CTA launch of the same call (bit for bit where the
arithmetic is the same: the tap-sum's steps and the reuse folds' planes
split over the cluster) or to the plain version (the composed
contraction split by dz, whose sums are added in parts), then time the
formerly refused cells.

    python src/repro_torch/benchmarks/cluster_probe.py [calls | times | all | workspace]

``workspace`` builds the main and the workspace libraries only, forces
the tile rule's fourth rung (``budget=1`` of the wrappers: no CTA or
cluster holds any layout) on tiles one CTA holds, and holds every
workspace launch to the one-CTA launch of the same call bit for bit: the
2D and 3D tap-sums (r = 1..7), the reuse folds dense and compacted, and
the composed contraction (the 2D one 128 deep), on ragged grids,
periodic and not, float32 and bfloat16 grids, TF32 and bf16 operands.
Then the cells no CTA or cluster holds (the 3D tap-sum at r = 3, t = 8
and r = 7, t = 2, the reuse folds at r = 5 and 6, the composed
contraction 64 and 72 deep, the 2D tap-sum and reuse fold at h = 112)
against the plain version within chip_smoke.py's ``kernel_limit``, which
must reject the plain version one step short.

Every mode first builds every library (``_build.build_all``: the build
times are printed).  ``calls`` runs every 3D kernel on tiles one CTA
holds, each at budgets that spread its layout over clusters of 2, 4 and
8 CTAs (``budget=`` of the plan entries: the tile rule's third rung at a
smaller per-CTA share), on 40x72x100 and 60x70x130 grids (ragged tiles),
periodic and under (replicate, reflect, periodic) and (zero, zero,
reflect), float32 and bfloat16 grids, TF32 and bf16 operands: the
tap-sum (Box/Star-3D, r = 1..3) and the reuse folds, dense and
compacted, must equal the one-CTA launch bit for bit; the composed
contraction must meet chip_smoke.py's ``kernel_limit`` against the plain
version, which must reject the plain version one step short.  Then the
deep cells themselves on 64^3 and 40x72x100 (Box/Star-3D2R, the tap-sum
at h = 12, 14, 16, the composed contraction at h = 12..16, the reuse
folds at t = 8), against the plain version.  ``times`` times the 16
formerly refused cells and ``auto`` at 512^3 (f32) through
``stencil_plan``, one call after a warm one, with each plan's launch
tile, and prints the card's name and power limit.  Run from the
repository's root, and redirect the output into a directory made first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

import importlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build, common, registry  # noqa: E402
from repro_torch.stencil import StencilSpec, make_weights  # noqa: E402
from repro_torch.stencil.weights import fuse_weights  # noqa: E402

sd = importlib.import_module("repro_torch.kernels.stencil_direct")
sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
ss = importlib.import_module("repro_torch.kernels.stencil_sparse")

SHAPES = ((40, 72, 100), (60, 70, 130))
BOUNDARIES = (None, ("replicate", "reflect", "periodic"), ("zero", "zero", "reflect"))
DEEP_SHAPES = ((64, 64, 64), (40, 72, 100))


def budgets(layout_of, full: int):
    """``(C, budget)`` for C in 2, 4, 8: the largest budget below the
    one-CTA layout's ``full`` bytes at which ``layout_of(budget)`` spreads
    over C CTAs, found by halving and bisecting; C that no budget gives
    is left out."""
    found = {}
    lo_b = full - 1
    for _ in range(40):
        lay = layout_of(lo_b)
        if lay is None:
            break
        found.setdefault(lay.ctas, lo_b)
        lo_b = int(lo_b * 0.8)
    return sorted(found.items())


def codes(bc, dim=3):
    from repro_torch.stencil.boundary import resolve_boundary
    return common.kernel_mode_codes(resolve_boundary(bc, dim))


def probe_calls() -> int:
    bad = n = 0
    for shape, bc, dt in ((s, b, d) for s in SHAPES for b in BOUNDARIES
                          for d in (torch.float32, torch.bfloat16)):
        x = cs.grid(shape, dt, seed=1)
        xb = x.unsqueeze(0)
        for kind, r, t in (("box", 1, 4), ("star", 1, 5), ("box", 2, 3), ("star", 2, 4),
                           ("box", 3, 2), ("star", 3, 3)):
            w = cs.wide_weights(weights_mod(), kind, 3, r)
            halo = t * r
            # the tap-sum
            geom = common.launch_geom(shape, halo, need=sd.tile_need(shape, r, t, dt))
            one = sd._launch3d(xb, w, t, r, geom, codes(bc))
            full = common.direct3d_layout(geom.strip_m, geom.w_tile, r, t).smem_bytes
            for c, b in budgets(lambda b: common.direct3d_cluster(
                    geom.strip_m, geom.w_tile, r, t, b), full):
                y = sd._launch3d(xb, w, t, r, geom, codes(bc), budget=b)
                d = cs.max_err(y, one)
                n += 1
                if d != 0.0:
                    bad += 1
                    print(f"DIFFERS tap-sum {kind} r={r} t={t} {shape} {dt} {bc} C={c}: {d:.3e}")
            # the reuse folds, dense and compacted, both operand dtypes
            for cdt in (torch.float32, torch.bfloat16):
                for mod, name in ((sm, "banded"), (ss, "sparse")):
                    need = mod.tile_need(shape, w, t, dt, cdt)
                    geom = common.launch_geom(shape, halo, need=need)
                    one = mod._launch3d(xb, w, t, r, cdt, geom, codes(bc))
                    full = need.smem(geom.z_slab, geom.strip_m, geom.w_tile)
                    for c, b in budgets(lambda b: need.cluster(
                            geom.z_slab, geom.strip_m, geom.w_tile, b), full):
                        y = mod._launch3d(xb, w, t, r, cdt, geom, codes(bc), budget=b)
                        d = cs.max_err(y, one)
                        n += 1
                        if d != 0.0:
                            bad += 1
                            print(f"DIFFERS reuse {name} {kind} r={r} t={t} {shape} {dt} "
                                  f"{cdt} {bc} C={c}: {d:.3e}")
            # the composed contraction (periodic only, as the regime)
            if bc is None and t > 1:
                wf = fuse_weights(w, t)
                for cdt in (torch.float32, torch.bfloat16):
                    need = sm.tile_need(shape, wf, 1, dt, cdt)
                    geom = common.launch_geom(shape, halo, need=need)
                    full = need.smem(geom.z_slab, geom.strip_m, geom.w_tile)
                    one = sm._launch3d(xb, wf, 1, halo, cdt, geom, codes(bc))[0]
                    ops = "bf16" if cdt == torch.bfloat16 else "tf32"
                    for c, b in budgets(lambda b: need.cluster(
                            geom.z_slab, geom.strip_m, geom.w_tile, b), full):
                        y = sm._launch3d(xb, wf, 1, halo, cdt, geom, codes(bc), budget=b)[0]
                        ok, msg = hold(x, y, w, t, cdt, ops, dt)
                        n += 1
                        if not ok:
                            bad += 1
                        print(f"composed {kind} r={r} t={t} {shape} {str(dt)[6:]} {ops} C={c}: "
                              f"{msg}; vs one CTA {cs.max_err(y, one):.3e}")
        del x, xb
    print(f"cluster forms vs one CTA: {n} calls, {bad} outside (bit for bit, or the limit)")
    return bad


def weights_mod():
    return importlib.import_module("repro_torch.stencil.weights")


def hold(x, y, w, t, cdt, ops, dt, what="composed"):
    """(ok, message): ``y`` against the plain version of t steps of ``w``,
    within chip_smoke.py's kernel_limit, which must reject the plain
    version one step short: the tap-sum's and the reuse fold's t steps,
    step by step; the composed contraction's one step of the composed
    kernel, short by the kernel composed t - 1 times (as phase ``wide``
    holds them)."""
    bf = dt == torch.bfloat16
    if what == "composed":
        wk, tk = fuse_weights(w, t), 1
        step = lambda v: sm.stencil_matmul_plain(v, wk, 1, compute_dtype=cdt)  # noqa: E731
        short = sm.stencil_matmul_plain(x, fuse_weights(w, t - 1), 1, compute_dtype=cdt)
    elif what == "tap-sum":
        wk, tk = w, t
        step = lambda v: sd.stencil_direct_plain(v, w, 1)  # noqa: E731
        short = None
    else:
        wk, tk = w, t
        step = lambda v: sm.stencil_matmul_plain(v, w, 1, compute_dtype=cdt)  # noqa: E731
        short = None
    if what == "tap-sum":
        plain = sd.stencil_direct_plain(x, w, t)
    else:
        plain = sm.stencil_matmul_plain(x, wk, tk, compute_dtype=cdt)
    err = cs.max_err(y, plain)
    maxima, prev = cs.plain_chain(step, x, tk)
    if what == "tap-sum" and not bf:
        tol = 1e-5 * maxima[0]
    else:
        tol = cs.kernel_limit(ops, float(np.abs(wk).sum()), int(np.count_nonzero(wk)),
                              maxima, bf)
    wrong = cs.max_err(y, prev if short is None else short)
    ok = err <= tol and wrong > tol
    return ok, (f"{'ok' if ok else 'FAILS'} err {err:.3e} tol {tol:.3e} "
                f"(t-1: {wrong:.3e})")


def probe_deep() -> int:
    bad = n = 0
    for shape, dt in ((s, d) for s in DEEP_SHAPES for d in (torch.float32, torch.bfloat16)):
        x = cs.grid(shape, dt, seed=2)
        for kind, t in (("box", 6), ("star", 7), ("box", 8), ("star", 8)):
            w = cs.wide_weights(weights_mod(), kind, 3, 2)
            calls = [("tap-sum", sd.tile_need(shape, 2, t, dt),
                      lambda g: sd.stencil_direct_at(x, w, t, g), torch.float32, "f32")]
            for cdt in (torch.float32, torch.bfloat16):
                ops = "bf16" if cdt == torch.bfloat16 else "tf32"
                wf = fuse_weights(w, t)
                calls.append(("composed", sm.tile_need(shape, wf, 1, dt, cdt),
                              lambda g, wf=wf, cdt=cdt: sm.stencil_matmul_at(x, wf, 1, g, cdt),
                              cdt, ops))
                if t == 8:
                    calls.append(("reuse", sm.tile_need(shape, w, t, dt, cdt),
                                  lambda g, cdt=cdt: sm.stencil_matmul_at(x, w, t, g, cdt),
                                  cdt, ops))
                    calls.append(("reuse-sparse", ss.tile_need(shape, w, t, dt, cdt),
                                  lambda g, cdt=cdt: ss.stencil_sparse_matmul_at(x, w, t, g, cdt),
                                  cdt, ops))
            for what, need, call, cdt, ops in calls:
                halo = 2 * t
                geom = common.launch_geom(shape, halo, need=need)
                full = need.smem(geom.z_slab, geom.strip_m, geom.w_tile)
                lay = need.cluster(geom.z_slab, geom.strip_m, geom.w_tile,
                                   common.smem_budget_bytes()) \
                    if full > common.SMEM_BUDGET_BYTES else None
                y = call(geom)
                ok, msg = hold(x, y, w, t, cdt, ops, dt,
                               "reuse" if what.startswith("reuse") else what)
                n += 1
                bad += not ok
                print(f"deep {what} {kind} t={t} h={halo} {shape} {str(dt)[6:]} {ops} tile "
                      f"{geom.z_slab}x{geom.strip_m}x{geom.w_tile} "
                      f"C={lay.ctas if lay else 1}: {msg}")
        del x
    print(f"deep cells vs plain: {n} calls, {bad} outside their limits")
    return bad


#: The workspace probe's bit-for-bit cases: (rank, kind, r, t).
WS_CASES = {3: (("box", 1, 4), ("star", 3, 2), ("box", 5, 1), ("star", 7, 1), ("box", 2, 3)),
            2: (("box", 1, 4), ("star", 3, 3), ("box", 7, 2), ("box", 7, 8))}
WS_SHAPES = {3: ((40, 72, 100), (60, 70, 130)), 2: ((1000, 1030), (256, 256))}
WS_BOUNDARIES = {3: (None, ("replicate", "reflect", "periodic")), 2: (None, ("reflect", "zero"))}


def probe_workspace_calls() -> int:
    """Each kernel's workspace form, forced with ``budget=1``, against its
    one-CTA launch on the same tile, bit for bit; returns the calls that
    differ."""
    bad = n = 0
    for dim in (3, 2):
        for shape, bc, dt in ((s, b, d) for s in WS_SHAPES[dim] for b in WS_BOUNDARIES[dim]
                              for d in (torch.float32, torch.bfloat16)):
            x = cs.grid(shape, dt, seed=1)
            xb = x.unsqueeze(0)
            cc = codes(bc, dim)
            for kind, r, t in WS_CASES[dim]:
                w = cs.wide_weights(weights_mod(), kind, dim, r)
                calls = []
                if t * r <= (9 if dim == 3 else 56):     # one CTA holds the tap-sum
                    geom = common.launch_geom(shape, t * r, need=sd.tile_need(shape, r, t, dt))
                    launch = sd._launch3d if dim == 3 else sd._launch2d
                    calls.append(("tap-sum", lambda b, g=geom, f=launch: f(
                        xb, w, t, r, g, cc, budget=b)))
                for cdt in (torch.float32, torch.bfloat16):
                    for mod, name in ((sm, "banded"), (ss, "sparse")):
                        need = mod.tile_need(shape, w, t, dt, cdt)
                        geom = common.launch_geom(shape, t * r, need=need)
                        launch = mod._launch3d if dim == 3 else mod._launch2d
                        if need.smem(geom.z_slab, geom.strip_m, geom.w_tile) <= \
                                common.SMEM_BUDGET_BYTES:
                            calls.append((f"reuse {name} {str(cdt)[6:]}",
                                          lambda b, g=geom, f=launch, cdt=cdt: f(
                                              xb, w, t, r, cdt, g, cc, budget=b)))
                    if bc is None and t > 1:
                        wf = fuse_weights(w, t)
                        need = sm.tile_need(shape, wf, 1, dt, cdt)
                        geom = common.launch_geom(shape, t * r, need=need)
                        launch = sm._launch3d if dim == 3 else sm._launch2d
                        if need.smem(geom.z_slab, geom.strip_m, geom.w_tile) <= \
                                common.SMEM_BUDGET_BYTES:
                            calls.append((f"composed {str(cdt)[6:]}",
                                          lambda b, g=geom, f=launch, wf=wf, cdt=cdt: f(
                                              xb, wf, 1, t * r, cdt, g, cc, budget=b)))
                for what, call in calls:
                    kernels.reset_launch_counts()
                    one = call(None)
                    ws = call(1)
                    torch.cuda.synchronize()
                    moved = {k: v for k, v in kernels.launch_counts().items() if v}
                    d = cs.max_err(ws, one)
                    n += 1
                    form = [k for k in moved if k.endswith("(workspace)")]
                    if d != 0.0 or len(form) != 1 or len(moved) != 2:
                        bad += 1
                        print(f"DIFFERS {dim}D {what} {kind} r={r} t={t} {shape} "
                              f"{str(dt)[6:]} {bc}: {d:.3e}, launches {moved}")
            del x, xb
    print(f"workspace forms vs one CTA: {n} calls, {bad} not bit for bit")
    return bad


#: The workspace probe's cells past any CTA and cluster: (rank, shape,
#: kind, r, t, what, grid dtypes).  The reuse and composed folds of a box
#: in bf16 operands fit a cluster here; the bf16 reuse fold 16 steps deep
#: moves by less than its limit's own bf16 terms in one step, so no limit
#: tells it from one step short (float32 grids only there).
F32, BF16 = torch.float32, torch.bfloat16
WS_DEEP = ((3, (64, 64, 64), "box", 3, 8, "tap-sum", (F32, BF16)),
           (3, (40, 72, 100), "star", 7, 2, "tap-sum", (F32, BF16)),
           (3, (64, 64, 64), "box", 5, 3, "reuse", (F32,)),
           (3, (40, 72, 100), "star", 6, 5, "sparse", (F32, BF16)),
           (3, (64, 64, 64), "box", 3, 8, "composed", (F32,)),
           (3, (64, 64, 64), "star", 4, 7, "composed", (F32, BF16)),
           (2, (1024, 1024), "box", 7, 16, "tap-sum", (F32, BF16)),
           (2, (1000, 1030), "box", 7, 16, "reuse", (F32,)))


def probe_workspace_deep() -> int:
    """The WS_DEEP cells, each on the tile the rule's fourth rung picks,
    float32 and bfloat16 grids, against the plain version (``hold``);
    returns the calls outside their limits."""
    bad = n = 0
    for dim, shape, kind, r, t, what, dtypes in WS_DEEP:
        w = cs.wide_weights(weights_mod(), kind, dim, r)
        for dt in dtypes:
            x = cs.grid(shape, dt, seed=2)
            cdt = dt
            ops = "bf16" if cdt == torch.bfloat16 else "tf32"
            if what == "tap-sum":
                need, call = sd.tile_need(shape, r, t, dt), \
                    lambda g: sd.stencil_direct_at(x, w, t, g)
                cdt, ops = torch.float32, "f32"
            elif what == "composed":
                wf = fuse_weights(w, t)
                need, call = sm.tile_need(shape, wf, 1, dt, cdt), \
                    lambda g: sm.stencil_matmul_at(x, wf, 1, g, cdt)
            else:
                mod, at = ((sm, sm.stencil_matmul_at) if what == "reuse"
                           else (ss, ss.stencil_sparse_matmul_at))
                need, call = mod.tile_need(shape, w, t, dt, cdt), \
                    lambda g: at(x, w, t, g, cdt)
            geom = common.launch_geom(shape, t * r, need=need)
            kernels.reset_launch_counts()
            y = call(geom)
            torch.cuda.synchronize()
            moved = {k: v for k, v in kernels.launch_counts().items() if v}
            ok, msg = hold(x, y, w, t, cdt, ops, dt,
                           "reuse" if what in ("reuse", "sparse") else what)
            ok = ok and len(moved) == 1 and next(iter(moved)).endswith("(workspace)")
            n += 1
            bad += not ok
            lay = common.as_workspace(
                need.workspace(geom.z_slab, geom.strip_m, geom.w_tile).base, x.device)
            tile = (f"{geom.z_slab}x" if dim == 3 else "") + f"{geom.strip_m}x{geom.w_tile}"
            print(f"deep workspace {dim}D {what} {kind} r={r} t={t} {shape} {str(dt)[6:]} tile "
                  f"{tile}, {lay.total_bytes / 2**20:.1f} MiB ({lay.ctas} x "
                  f"{lay.slice_bytes} B): {msg}; launches {moved}")
            del x, y
        torch.cuda.empty_cache()
    print(f"workspace cells vs plain: {n} calls, {bad} outside their limits")
    return bad


def probe_times() -> None:
    from repro_torch.kernels.plan import auto_decision
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    shape = (512, 512, 512)
    x = cs.grid(shape, torch.float32, seed=0)
    for pattern in ("Box-3D2R", "Star-3D2R"):
        spec = StencilSpec.from_name(pattern)
        w = make_weights(spec, seed=0)
        for t, backends in ((6, ("fused_direct", "fused_matmul", None)),
                            (7, ("fused_direct", "fused_matmul", None)),
                            (8, ("fused_direct", "fused_matmul", "fused_matmul_reuse",
                                 "fused_sparse_matmul", None))):
            for b in backends:
                plan = kernels.stencil_plan(w, shape, torch.float32, t, backend=b)
                t0 = time.perf_counter()
                plan(x)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                ms = cs.cuda_ms(lambda: plan(x), reps=1, warmup=0)
                g = registry.get_backend(plan.backend).audit(plan.ctx).launches[0].geom
                print(f"{pattern} t={t} {b or 'auto:' + plan.backend:28s} tile "
                      f"{g.z_slab}x{g.strip_m}x{g.w_tile} first {first:.3f} s, "
                      f"{ms:.3f} ms; on {card}")
        del w
    print(f"auto at t=6: {auto_decision(StencilSpec.from_name('Box-3D2R'), shape, torch.float32, 6)[1].backend}")


def main(argv) -> int:
    mode = argv[0] if argv else "all"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(_build.WORKSPACED + tuple(f"{k}_workspace" for k in _build.WORKSPACED)
                     if mode == "workspace" else _build.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()))
    for k, log in _build.build_logs.items():
        for line in log.splitlines():
            if ("cluster" in line or k.endswith("_workspace")) and (
                    "registers" in line or "Function properties" in line
                    or "spill" in line):
                print(f"  {k}: {line.strip()}")
    bad = 0
    if mode == "workspace":
        bad += probe_workspace_calls()
        bad += probe_workspace_deep()
    if mode in ("calls", "all"):
        bad += probe_calls()
        bad += probe_deep()
    if mode in ("times", "all"):
        probe_times()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
