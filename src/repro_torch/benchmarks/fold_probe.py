"""A short check of the folded 1D banded kernels on one card: build them,
hold them to the 2D kernel on the lifted (1, N) view (bit for bit), to
each other (compacted against dense, bit for bit) and to the plain
version, then time them at 2^26 points.

    python src/repro_torch/benchmarks/fold_probe.py

It builds four libraries (the two folded kernels and the two lifted ones
they are compared with), runs 320 calls (2^20 + 3, 2^20, 67 and 1000
points; Box-1D with (r, t) in {(1, 1), (1, 4), (3, 1), (3, 4), (2, 4)};
periodic, zero, reflect and replicate; every grid and operand dtype
pair) and prints each call that differs, then the milliseconds per call
of ``stencil_matmul`` / ``stencil_sparse_matmul`` at t=4, the composed
kernel and t=1 on 2^26 float32 points, beside the lifted kernel doing the
same call (the mean over 10 calls after 3, CUDA events).  Exits 1 if a
call differs.  ``chip_smoke.py`` runs the same checks among all others;
this is the quick one for a kernel change.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import numpy as np
    import torch
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
    if not torch.cuda.is_available():
        print("fold_probe: no CUDA device", file=sys.stderr)
        return 1
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build_all(("stencil_banded1d", "stencil_sparse1d",
                      "stencil_banded", "stencil_sparse"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False

    def lifted(mod, x, w, t, cdt, bc):
        r = (w.shape[0] - 1) // 2
        geom = common.launch_geom(x.shape, t * r)
        codes = common.kernel_mode_codes(common.resolve_boundary(bc, 1))
        return mod._launch2d(x.view(1, 1, -1), common.lift_weights(w), t, r,
                             cdt, geom, codes).view(x.shape)

    bad = calls = 0
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))
    for n in (2**20, 2**20 + 3, 67, 1000):
        for r, t in ((1, 1), (1, 4), (3, 1), (3, 4), (2, 4)):
            for bc in (None, "zero", "reflect", "replicate"):
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
    print(f"{calls} calls, {bad} differ")

    def ms(fn, reps=10):
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
            print(f"  {name:20s} {ms(fold):.4f} ({ms(lift, 3):.4f})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
