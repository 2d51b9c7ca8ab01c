"""A short check of the folded 1D kernels on one card: build them, hold
them to the 2D kernel on the lifted (1, N) view (bit for bit), the
compacted banded kernel to the dense one (bit for bit), and each to its
plain version, then time them at 2^26 points.

    python src/repro_torch/benchmarks/fold_probe.py [banded | tapsum]

``banded`` (or no argument) builds the two folded banded kernels and the
two lifted ones they are compared with, runs 320 calls (2^20 + 3, 2^20,
67 and 1000 points; Box-1D with (r, t) in {(1, 1), (1, 4), (3, 1), (3,
4), (2, 4)}; periodic, zero, reflect and replicate; every grid and
operand dtype pair) and prints each call that differs, then the
milliseconds per call of ``stencil_matmul`` / ``stencil_sparse_matmul``
at t=4, the composed kernel and t=1 on 2^26 float32 points, beside the
lifted kernel doing the same call.  ``tapsum`` (or no argument) builds
the folded tap-sum ``stencil_direct1d`` and the lifted 2D tap-sum, prints
the new kernel's ptxas lines, runs the tap-sum's 320 calls (the same
lines, radii, depths and boundaries; float32 and bfloat16 lines; the Box
weights and the same weights with every other tap zero, which the kernel
skips), then the milliseconds of ``stencil_direct`` at t=4 (one launch)
and t=1 and of four launches at t=1 (the ``direct`` regime) on 2^26
float32 points, periodic and ``reflect``, beside the lifted kernel doing
the same calls and F.conv1d (one step of the composed kernel, periodic;
4 x (F.pad + F.conv1d) under ``reflect``).  Times are the mean over 10
calls after 3, CUDA events.  Exits 1 if a call differs.
``chip_smoke.py`` runs the same checks among all others; this is the
quick one for a kernel change.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time


LINES = (2**20, 2**20 + 3, 67, 1000)
DEPTHS = ((1, 1), (1, 4), (3, 1), (3, 4), (2, 4))
BOUNDARIES = (None, "zero", "reflect", "replicate")


def ms(torch, fn, reps=10):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after 3, from CUDA
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch
    if argv not in ([], ["banded"], ["tapsum"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fold_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad = 0
    if argv != ["tapsum"]:
        bad += probe_banded(torch)
    if argv != ["banded"]:
        bad += probe_tapsum(torch)
    return 1 if bad else 0


def probe_banded(torch) -> int:
    """The folded banded kernels: 320 calls against the lift, the dense
    kernel and the plain version, then their times; returns the calls
    that differ."""
    import numpy as np
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    t0 = time.perf_counter()
    _build.build_all(("stencil_banded1d", "stencil_sparse1d",
                      "stencil_banded", "stencil_sparse"))
    print(f"build {time.perf_counter() - t0:.1f} s")

    def lifted(mod, x, w, t, cdt, bc):
        r = (w.shape[0] - 1) // 2
        geom = common.launch_geom(x.shape, t * r)
        codes = common.kernel_mode_codes(common.resolve_boundary(bc, 1))
        return mod._launch2d(x.view(1, 1, -1), common.lift_weights(w), t, r,
                             cdt, geom, codes).view(x.shape)

    bad = calls = 0
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))
    for n in LINES:
        for r, t in DEPTHS:
            for bc in BOUNDARIES:
                if bc == "reflect" and n < t * r + 1:
                    continue
                w = make_weights(StencilSpec("box", 1, r), seed=1)
                for dt, cdt in pairs:
                    x = torch.from_numpy(np.random.default_rng(2).normal(
                        size=n).astype(np.float32)).cuda().to(dt)
                    y = sm.stencil_matmul(x, w, t, compute_dtype=cdt,
                                          boundary=bc)
                    d_lift = float((y.float() - lifted(sm, x, w, t, cdt, bc)
                                    .float()).abs().max())
                    d_sparse = float((y.float() - ss.stencil_sparse_matmul(
                        x, w, t, compute_dtype=cdt, boundary=bc).float())
                        .abs().max())
                    e_plain = float((y.float() - sm.stencil_matmul_plain(
                        x, w, t, compute_dtype=cdt, boundary=bc).float())
                        .abs().max())
                    calls += 1
                    if d_lift or d_sparse or not e_plain < 0.05 * t:
                        bad += 1
                        print(f"n={n} r={r} t={t} bc={bc} {dt} {cdt}: vs lift "
                              f"{d_lift:.3e}, vs compacted {d_sparse:.3e}, "
                              f"vs plain {e_plain:.3e}")
    print(f"banded: {calls} calls, {bad} differ")

    x = torch.from_numpy(np.random.default_rng(0).normal(size=2**26)
                         .astype(np.float32)).cuda()
    w = make_weights(StencilSpec("box", 1, 1), seed=0)
    wf = fuse_weights(w, 4)
    f32 = torch.float32
    for bc in (None, "reflect"):
        print(f"2^26 Box-1D1R f32, boundary {bc}: ms per call (lifted kernel)")
        cases = [("fused_matmul_reuse", lambda: sm.stencil_matmul(x, w, 4, boundary=bc),
                  lambda: lifted(sm, x, w, 4, f32, bc)),
                 ("fused_sparse_matmul", lambda: ss.stencil_sparse_matmul(x, w, 4, boundary=bc),
                  lambda: lifted(ss, x, w, 4, f32, bc)),
                 ("t=1", lambda: sm.stencil_matmul(x, w, 1, boundary=bc),
                  lambda: lifted(sm, x, w, 1, f32, bc))]
        if bc is None:
            cases.append(("composed R=4", lambda: sm.stencil_matmul(x, wf, 1),
                          lambda: lifted(sm, x, wf, 1, f32, None)))
        for name, fold, lift in cases:
            print(f"  {name:20s} {ms(torch, fold):.4f} ({ms(torch, lift, 3):.4f})")
    return bad


def probe_tapsum(torch) -> int:
    """The folded tap-sum: 320 calls against the lift and the plain
    version, then its times beside the lift's and F.conv1d's; returns the
    calls that differ."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import (StencilSpec, fuse_weights, make_weights,
                                     resolve_boundary)
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    t0 = time.perf_counter()
    _build.build_all(("stencil_direct1d", "stencil_direct"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in _build.build_logs.get("stencil_direct1d", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    def lifted(x, w, t, bc):
        r = (w.shape[0] - 1) // 2
        geom = common.launch_geom(tuple(x.shape), t * r)
        codes = common.kernel_mode_codes(resolve_boundary(bc, 1))
        return sd._launch2d(x.view(1, 1, -1), common.lift_weights(w), t, r,
                            geom, codes).view(x.shape)

    bad = calls = 0
    for n in LINES:
        for r, t in DEPTHS:
            for bc in BOUNDARIES:
                box = make_weights(StencilSpec("box", 1, r), seed=1)
                gaps = box.copy()
                gaps[1::2] = 0.0
                for w in (box, gaps):
                    w = np.asarray(w, np.float32)
                    for dt in (torch.float32, torch.bfloat16):
                        x = torch.from_numpy(np.random.default_rng(2).normal(
                            size=n).astype(np.float32)).cuda().to(dt)
                        y = sd.stencil_direct(x, w, t, boundary=bc)
                        d_lift = float((y.float() - lifted(x, w, t, bc).float())
                                       .abs().max())
                        e_plain = float((y.float() - sd.stencil_direct_plain(
                            x, w, t, bc).float()).abs().max())
                        calls += 1
                        if d_lift or not e_plain < 0.05 * t:
                            bad += 1
                            print(f"n={n} r={r} t={t} bc={bc} {dt} taps "
                                  f"{np.count_nonzero(w)}: vs lift {d_lift:.3e}, "
                                  f"vs plain {e_plain:.3e}")
    print(f"tap-sum: {calls} calls, {bad} differ from the lift or the plain version")

    x = torch.from_numpy(np.random.default_rng(0).normal(size=2**26)
                         .astype(np.float32)).cuda()
    w = np.asarray(make_weights(StencilSpec("box", 1, 1), seed=0), np.float32)
    wt = torch.from_numpy(w).cuda()[None, None]
    wf = torch.from_numpy(np.asarray(fuse_weights(w, 4), np.float32)).cuda()[None, None]

    def conv(bc):
        if bc is None:
            return lambda: F.conv1d(F.pad(x[None, None], (4, 4), mode="circular"), wf)
        def run():
            y = x[None, None]
            for _ in range(4):
                y = F.conv1d(F.pad(y, (1, 1), mode=bc), wt)
            return y
        return run

    def four(fn):
        def run():
            y = x
            for _ in range(4):
                y = fn(y)
            return y
        return run

    for bc in (None, "reflect"):
        print(f"2^26 Box-1D1R f32, boundary {bc}: ms per call (lifted kernel)")
        for name, fold, lift in (
                ("fused_direct (t=4)", lambda: sd.stencil_direct(x, w, 4, boundary=bc),
                 lambda: lifted(x, w, 4, bc)),
                ("t=1", lambda: sd.stencil_direct(x, w, 1, boundary=bc),
                 lambda: lifted(x, w, 1, bc)),
                ("direct (4 x t=1)", four(lambda v: sd.stencil_direct(v, w, 1, boundary=bc)),
                 four(lambda v: lifted(v, w, 1, bc)))):
            print(f"  {name:20s} {ms(torch, fold):.4f} ({ms(torch, lift, 3):.4f})")
        print(f"  {'F.conv1d':20s} {ms(torch, conv(bc)):.4f}"
              + (" (composed, one step)" if bc is None else " (4 x (F.pad + F.conv1d))"))
    return bad


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
