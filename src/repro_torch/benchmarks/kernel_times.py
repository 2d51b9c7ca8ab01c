"""Device times of the unbatched main-path plans, for comparing two
checkouts of the port on one card (parent, change, change, parent).

    python src/repro_torch/benchmarks/kernel_times.py [--src CHECKOUT/src] [OUT.json]
    python src/repro_torch/benchmarks/kernel_times.py --compare P1 C1 C2 P2

The first form imports ``repro_torch`` from ``--src`` (default: the
checkout this file is in), builds its kernels there, and times
``stencil_plan(w, shape, float32, 4, backend=b)(x)`` for every regime of
the main paths -- 8192^2 Box-2D1R and Star-2D1R, 512^3 Box-3D1R, 2^26
Box-1D1R; the five regimes and, with ``use_sparse_unit``, the two
compacted ones -- as the median of ``REPS`` CUDA-event timings after
warm-up (unbatched: B = 1 on the batched kernels).  It prints, and
writes to OUT.json, ``{"card": ..., "times": {case: ms}}``.  It uses only
the plan API, so it runs on any checkout of the port.

The second form reads four such files taken in turns on one card and
prints each case's change/parent ratio against the parents' own spread.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

REPS = 15
MAIN_T = 4
PATHS = (("2D", (8192, 8192), ("box", "star")), ("3D", (512, 512, 512), ("box",)),
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


def measure(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    from repro_torch.kernels import build_all, stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times measures device time and needs a card")
    build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
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
        del x
    return {"card": card, "src": src, "times": times}


def compare(paths) -> None:
    p1, c1, c2, p2 = (json.load(open(p)) for p in paths)
    print(f"cards: {', '.join(d['card'] for d in (p1, c1, c2, p2))}")
    print(f"{'case':36s} {'parent':>9s} {'change':>9s} {'change':>9s} {'parent':>9s}"
          f" {'chg/par':>8s} {'par/par':>8s}")
    ratios = []
    for case in p1["times"]:
        a, b, c, d = (r["times"][case] for r in (p1, c1, c2, p2))
        ratio = (b + c) / (a + d)
        ratios.append(ratio)
        print(f"{case:36s} {a:9.4f} {b:9.4f} {c:9.4f} {d:9.4f} {ratio:8.3f} "
              f"{max(a, d) / min(a, d):8.3f}")
    print(f"change/parent over {len(ratios)} cases: median "
          f"{statistics.median(ratios):.3f}, {min(ratios):.3f}..{max(ratios):.3f}")


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
