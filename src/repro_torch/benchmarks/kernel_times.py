"""Device times of the unbatched main-path plans, for comparing two
checkouts of the port on one card (parent, change, change, parent).

    python src/repro_torch/benchmarks/kernel_times.py [--src CHECKOUT/src] [OUT.json]
    python src/repro_torch/benchmarks/kernel_times.py --compare P1 C1 C2 P2

The first form imports ``repro_torch`` from ``--src`` (default: the
checkout this file is in), builds its kernels there, and times
``stencil_plan(w, shape, float32, 4, backend=b)(x)`` for every regime of
the main paths -- 8192^2 Box-2D1R and Star-2D1R, 512^3 Box-3D1R and
Star-3D1R (the compacted kernel's cell), 2^26 Box-1D1R; the five regimes
and, with ``use_sparse_unit``, the two compacted ones -- as the median of
``REPS`` CUDA-event timings after warm-up (unbatched: B = 1 on the batched kernels).  On a checkout whose
1D banded regimes run the folded kernels (``stencil_matmul._launch1d``),
it also times each of them doing the same calls by the 2D kernel on the
lifted (1, N) view, the kernel those regimes ran before, as the case
``"1D box <regime> (lift)"``; likewise the tap-sum regimes ``direct`` and
``fused_direct`` where the checkout folds the tap-sum
(``stencil_direct._launch1d``).  It prints, and writes to OUT.json,
``{"card": ..., "times": {case: ms}}``.  Beyond those lifted cases it uses
only the plan API, so it runs on any checkout of the port.

The second form reads four such files taken in turns on one card and
prints the change/parent ratio of each case all four have, against the
parents' own spread, then the cases only the changes have beside the
parents' case of the same regime.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

REPS = 15
MAIN_T = 4
PATHS = (("2D", (8192, 8192), ("box", "star")), ("3D", (512, 512, 512), ("box", "star")),
         ("1D", (2**26,), ("box",)))
REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul")


def _median_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _lifted(modules, w, t: int, backend: str):
    """``f(x)``: the calls of a 1D plan of ``backend`` done by the 2D kernel
    on the lifted (1, N) view with the lifted kernel, or None where the
    checkout does not fold that regime's kernel."""
    sm, ss, sd, common, fuse = modules
    tapsum = backend in ("direct", "fused_direct")
    mod = sd if tapsum else ss if "sparse" in backend else sm
    steps = {"direct": (w, 1, t), "fused_direct": (w, t, 1),
             "matmul": (w, 1, t), "sparse_matmul": (w, 1, t),
             "fused_matmul": (fuse(w, t), 1, 1),
             "fused_matmul_reuse": (w, t, 1),
             "fused_sparse_matmul": (w, t, 1)}[backend]
    if not hasattr(mod, "_launch1d"):
        return None
    wk, tk, launches = steps
    r = (wk.shape[0] - 1) // 2
    w2 = common.lift_weights(np.asarray(wk, np.float32))
    dtype = () if tapsum else (torch.float32,)

    def run(x):
        geom = common.launch_geom(tuple(x.shape), tk * r)
        codes = common.kernel_mode_codes(("periodic",))
        for _ in range(launches):
            x = mod._launch2d(x.view(1, 1, -1), w2, tk, r, *dtype, geom,
                              codes).view(x.shape)
        return x
    return run


def measure(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import importlib

    from repro_torch.kernels import build_all, common, stencil_plan
    from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times measures device time and needs a card")
    build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    times = {}
    for label, shape, kinds in PATHS:
        x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                             .astype(np.float32)).cuda()
        for kind in kinds:
            w = make_weights(StencilSpec(kind, len(shape), 1), seed=0)
            for b in REGIMES:
                plan = stencil_plan(w, shape, torch.float32, MAIN_T, backend=b,
                                    use_sparse_unit=b.startswith(("sparse", "fused_sparse")))
                times[f"{label} {kind} {b}"] = _median_ms(torch, lambda: plan(x))
                lifted = len(shape) == 1 and _lifted(
                    (sm, ss, sd, common, fuse_weights), w, MAIN_T, b)
                if lifted:
                    times[f"{label} {kind} {b} (lift)"] = _median_ms(
                        torch, lambda: lifted(x))
        del x
    return {"card": card, "src": src, "times": times}


def compare(paths) -> None:
    p1, c1, c2, p2 = (json.load(open(p)) for p in paths)
    print(f"cards: {', '.join(d['card'] for d in (p1, c1, c2, p2))}")
    print(f"{'case':36s} {'parent':>9s} {'change':>9s} {'change':>9s} {'parent':>9s}"
          f" {'chg/par':>8s} {'par/par':>8s}")
    ratios = []
    shared = [c for c in p1["times"] if all(c in r["times"] for r in (c1, c2, p2))]
    for case in shared:
        a, b, c, d = (r["times"][case] for r in (p1, c1, c2, p2))
        ratio = (b + c) / (a + d)
        ratios.append(ratio)
        print(f"{case:36s} {a:9.4f} {b:9.4f} {c:9.4f} {d:9.4f} {ratio:8.3f} "
              f"{max(a, d) / min(a, d):8.3f}")
    print(f"change/parent over {len(ratios)} cases: median "
          f"{statistics.median(ratios):.3f}, {min(ratios):.3f}..{max(ratios):.3f}")
    for case in c1["times"]:
        if case in shared or case not in c2["times"]:
            continue
        base = case.rsplit(" (", 1)[0]
        b, c = c1["times"][case], c2["times"][case]
        par = [r["times"][base] for r in (p1, p2) if base in r["times"]]
        print(f"{case:36s} change {b:9.4f} {c:9.4f}"
              + (f"  parents' {base}: {' '.join(f'{v:.4f}' for v in par)}" if par else ""))


def main(argv) -> int:
    if argv[:1] == ["--compare"]:
        compare(argv[1:5])
        return 0
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if argv[:1] == ["--src"]:
        src, argv = argv[1], argv[2:]
    out = measure(src)
    print(json.dumps(out))
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
