#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), then the build of both
     CUDA kernels from src/repro_torch/kernels/csrc (one nvcc per source,
     started together) and its time;
  2. each kernel against its plain PyTorch version on the card, at 1024^2
     and a ragged 1000x1030 grid, box/star, r in {1, 3}, t in {1, 4},
     float32 and bfloat16 grids, the banded kernel with either operand
     dtype, each limit built from the plain version's step-by-step maxima
     and shown to reject the plain version one step short;
  3. the main path: ``stencil_plan(...)(x)`` on 8192^2 float32 grids
     (256 MiB per field, five times the 50 MB L2) for Box-2D1R and
     Star-2D1R at t=4, each of the five regimes and ``auto`` against the
     ``reference`` backend, with every kernel's launches counted;
  4. times from CUDA events (median of 15 after 3 warm-ups): each regime's
     microseconds per step beside the model's choice, its read
     amplification and its bound, each kernel beside its plain version
     and an F.conv2d yardstick the port never calls, and each wrapper's
     host time per launch.
The line before the last is the JSON kernel report, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks (NVIDIA; dense): HBM bytes/s, fp32 CUDA-core
#: and TF32 tensor-core FLOP/s.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

MAIN_SHAPE = (8192, 8192)
MAIN_T = 4
HOST_SHAPE = (256, 256)
HOST_CALLS = 500
REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", None)          # None = auto
KERNEL_SOURCES = {
    "stencil_direct": ("src/repro_torch/kernels/csrc/stencil_direct.cu",
                       "src/repro/kernels/stencil_direct.py:102"),
    "stencil_banded": ("src/repro_torch/kernels/csrc/stencil_banded.cu",
                       "src/repro/kernels/stencil_matmul.py:202"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn) -> float:
    """Host microseconds per call of ``fn``: wall clock over HOST_CALLS
    calls issued back to back, the card drained before and after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def grid(shape, dtype, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def conv_yardstick(x: torch.Tensor, w: np.ndarray, tf32: bool):
    """One F.conv2d of ``w`` on the circularly padded grid (pad included)."""
    r = (w.shape[0] - 1) // 2
    wt = torch.from_numpy(np.ascontiguousarray(w)).to(x.device, x.dtype)

    def run():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            xp = F.pad(x[None, None], (r, r, r, r), mode="circular")
            return F.conv2d(xp, wt[None, None])[0, 0]
    return run


def phase_build(kernels) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels import _build
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return card


def plain_chain(step, x: torch.Tensor, t: int):
    """The plain version one step at a time from ``x`` in f32: max|y_s| for
    s = 0..t, and y_{t-1}."""
    v = x.float()
    maxima, prev = [float(v.abs().max())], v
    for _ in range(t):
        prev, v = v, step(v)
        maxima.append(float(v.abs().max()))
    return maxima, prev


def kernel_limit(operands: str, sw: float, n_taps: int, maxima, out_bf16: bool) -> float:
    """Limit on max|kernel - plain| over t = len(maxima) - 1 steps, where
    maxima[s] is the plain version's max|y_s| (the input of step s, and for
    s = t the output).  A difference d in a step's input is at most Σ|w|·d
    in its output.  Each step adds, times Σ|w|·max|y_s|: the f32
    accumulation of either side in its own order, 2·n_taps·2⁻²³; for
    operands "tf32" the kernel's rounding of grid and weights against the
    plain version's exact f32, 2⁻¹⁰ (2⁻¹¹ each); for "bf16", rounded alike
    on both sides, one bf16 ulp, 2⁻⁷, where a differing f32 intermediate
    rounds to the neighbouring value (from s = 1 on: at s = 0 both round
    the same grid).  A bf16 output adds one ulp of max|y_t|."""
    tol = 0.0
    for s in range(len(maxima) - 1):
        e = 2 * n_taps * 2**-23
        if operands == "tf32":
            e += 2**-10
        elif operands == "bf16" and s > 0:
            e += 2**-7
        tol = sw * (tol + e * maxima[s])
    return tol + (2**-7 * maxima[-1] if out_bf16 else 0.0)


def phase_kernels_vs_plain(mods) -> None:
    """Every kernel against its plain version at phase-2 shapes, the banded
    kernel also with the other operand dtype (f32 grid, bf16 operands and
    the reverse).  Each limit must also reject the plain version one step
    short, so a kernel that skipped a step could not pass."""
    kernels, sm, sd, weights = mods
    worst, margin = {}, {}
    for shape in ((1024, 1024), (1000, 1030)):
        for kind in ("box", "star"):
            for r in (1, 3):
                w = weights.make_weights(weights_spec(kind, r), seed=1)
                for t in (1, 4):
                    wf = weights.fuse_weights(w, t)
                    for dtype in (torch.float32, torch.bfloat16):
                        x = grid(shape, dtype, seed=2)
                        bf = dtype == torch.bfloat16
                        other = torch.float32 if bf else torch.bfloat16

                        def banded(wk, tk, cdt, short=None):
                            ops = "bf16" if cdt == torch.bfloat16 else "tf32"
                            return (f"stencil_banded[{str(cdt)[6:]} operands]",
                                    lambda: sm.stencil_matmul(x, wk, tk, compute_dtype=cdt),
                                    lambda: sm.stencil_matmul_plain(x, wk, tk, compute_dtype=cdt),
                                    lambda v: sm.stencil_matmul_plain(v, wk, 1, compute_dtype=cdt),
                                    tk, ops, wk, short)
                        cases = [
                            ("stencil_direct", lambda: sd.stencil_direct(x, w, t),
                             lambda: sd.stencil_direct_plain(x, w, t),
                             lambda v: sd.stencil_direct_plain(v, w, 1), t, "f32", w, None),
                            banded(w, t, dtype), banded(w, t, other)]
                        if t > 1:
                            # One step short of the composed kernel: depth t-1.
                            cases.append(banded(wf, 1, dtype, lambda: sm.stencil_matmul_plain(
                                x, weights.fuse_weights(w, t - 1), 1, compute_dtype=dtype)))
                        for name, kern, plain, step, tk, ops, wk, short in cases:
                            y = kern()
                            torch.cuda.synchronize()
                            ref = plain()
                            err = max_err(y, ref)
                            maxima, prev = plain_chain(step, x, tk)
                            if name == "stencil_direct" and not bf:
                                tol = 1e-5 * maxima[0]
                            else:
                                tol = kernel_limit(ops, float(np.abs(wk).sum()),
                                                   int(np.count_nonzero(wk)), maxima, bf)
                            short = prev if short is None else short()
                            wrong = max_err(y, short)
                            tag = (f"{name} {kind} r={r} t={t} {shape} "
                                   f"{str(dtype)[6:]}" + ("" if tk == t else " composed"))
                            check(y.shape == x.shape and y.dtype == dtype,
                                  f"{tag}: shape/dtype {tuple(y.shape)} {y.dtype}")
                            check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
                            check(err <= tol, f"{tag}: max|err| {err:.3e} > tol {tol:.3e}")
                            check(wrong > tol, f"{tag}: the limit {tol:.3e} also passes the "
                                               f"plain version one step short ({wrong:.3e})")
                            worst[name] = max(worst.get(name, 0.0), err / tol)
                            margin[name] = max(margin.get(name, 0.0), tol / wrong)
    print("kernels vs plain: all configurations within tolerance; worst err/tol "
          + ", ".join(f"{k}={v:.3f}" for k, v in worst.items()))
    print("  and every limit rejects the plain version one step short; worst "
          "tol/err(t-1) " + ", ".join(f"{k}={v:.3f}" for k, v in margin.items()))


def weights_spec(kind: str, r: int):
    from repro_torch.stencil import StencilSpec
    return StencilSpec(kind, 2, r)


def expected_launches(backend: str, t: int):
    return {"direct": ("stencil_direct", t), "fused_direct": ("stencil_direct", 1),
            "matmul": ("stencil_banded", t), "fused_matmul": ("stencil_banded", 1),
            "fused_matmul_reuse": ("stencil_banded", 1)}[backend]


def phase_main_path(mods, x, ws):
    """Drive every regime and auto through stencil_plan; returns the plans,
    the outputs' errors and the launch counts of this run."""
    kernels, _, _, _ = mods
    from repro_torch.kernels import stencil_plan
    mx = float(x.abs().max())
    results = {}
    kernels.reset_launch_counts()
    for name, w in ws.items():
        ref = stencil_plan(w, MAIN_SHAPE, torch.float32, MAIN_T,
                           backend="reference")(x)
        sw = float(np.abs(w).sum())
        for backend in REGIMES:
            plan = stencil_plan(w, MAIN_SHAPE, torch.float32, MAIN_T,
                                backend=backend)
            before = kernels.launch_counts()
            y = plan(x)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            kname, n = expected_launches(plan.backend, MAIN_T)
            delta = {k: after[k] - before[k] for k in after}
            check(delta[kname] == n and sum(delta.values()) == n,
                  f"{name} {plan.backend}: launches {delta}, expected {n} "
                  f"of {kname}")
            check(tuple(y.shape) == MAIN_SHAPE and y.dtype == torch.float32,
                  f"{name} {plan.backend}: shape/dtype")
            check(bool(torch.isfinite(y).all()), f"{name} {plan.backend}: non-finite")
            err = max_err(y, ref)
            tol = (MAIN_T * 2**-10 * sw * mx if kname == "stencil_banded"
                   else 1e-5 * MAIN_T * mx)
            check(err <= tol, f"{name} {plan.backend}: max|err| vs reference "
                              f"{err:.3e} > tol {tol:.3e}")
            results[(name, backend or "auto")] = (plan, err, tol)
        del ref
    counts = kernels.launch_counts()
    for k, n in counts.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    print(f"main path: 5 regimes + auto x {list(ws)} on {MAIN_SHAPE} float32 "
          f"t={MAIN_T} match the reference; launches {counts}")
    return results, counts


def phase_times(mods, x, ws, results, counts, card):
    kernels, sm, sd, weights = mods
    common = kernels.common
    n = x.numel()
    print(f"times on {card} ({MAIN_SHAPE} float32, t={MAIN_T}; bound = "
          "max(bytes / 3.35 TB/s, useful FLOPs / unit peak)):")
    print("  stencil    regime              predicted           read_amp  "
          "ms/call    us/step    bound_ms   max|err|")
    for (name, regime), (plan, err, _) in results.items():
        ms = cuda_ms(lambda: plan(x))
        kname, launches = expected_launches(plan.backend, MAIN_T)
        k_taps = int(np.count_nonzero(ws[name]))
        peak = FP32_FLOPS if kname == "stencil_direct" else TF32_FLOPS
        bound = max(launches * 2 * n * 4 / HBM_BPS,
                    MAIN_T * 2 * k_taps * n / peak) * 1e3
        print(f"  {name:10s} {regime:19s} {plan.decision.backend:19s} "
              f"{plan.geom.read_amp:8.4f}  {ms:9.4f}  {ms * 1e3 / MAIN_T:9.2f}  "
              f"{bound:9.4f}  {err:.3e}")
    for name, w in ws.items():
        for tf32 in (False, True):
            ms = cuda_ms(conv_yardstick(x, w, tf32))
            print(f"  {name:10s} F.conv2d one step (tf32={tf32}): {ms:.4f} ms")
        # Structural S of the band operands, and S over the K the MMAs run
        # (BAND_N + 2R padded to the TF32 / bf16 K step).
        for label, wop in (("base", w), (f"fused t={MAIN_T}", weights.fuse_weights(w, MAIN_T))):
            r_op = (wop.shape[0] - 1) // 2
            s = sm.band_sparsity(wop, 16)
            padded = [s * (16 + 2 * r_op) / common.banded_layout(64, 64, r_op, 1, cb).kpad
                      for cb in (4, 2)]
            print(f"  {name:10s} band S ({label}, R={r_op}): {s:.4f}; over padded K: "
                  f"TF32 {padded[0]:.4f}, bf16 {padded[1]:.4f}")

    # The kernel report: each kernel at its fused main-path call on Box-2D1R,
    # held against its plain version with the phase-3 limit.
    w = ws["Box-2D1R"]
    wf = weights.fuse_weights(w, MAIN_T)
    n_rows = int(np.count_nonzero(np.abs(w).sum(axis=1)))
    mx, sw = float(x.abs().max()), float(np.abs(w).sum())
    report = []
    for kname, kern, plain, ops, peak, tf32, tol in (
            ("stencil_direct", lambda: sd.stencil_direct(x, w, MAIN_T),
             lambda: sd.stencil_direct_plain(x, w, MAIN_T),
             MAIN_T * 2 * int(np.count_nonzero(w)) * n, FP32_FLOPS, False,
             1e-5 * MAIN_T * mx),
            ("stencil_banded", lambda: sm.stencil_matmul(x, w, MAIN_T),
             lambda: sm.stencil_matmul_plain(x, w, MAIN_T),
             MAIN_T * n_rows * (16 + 2) * 2 * n, TF32_FLOPS, True,
             MAIN_T * 2**-10 * sw * mx)):
        y = kern()
        err = max_err(y, plain())
        del y
        check(err <= tol, f"kernel report {kname}: max|err| vs plain {err:.3e} "
                          f"> tol {tol:.3e}")
        bytes_ms = 2 * n * 4 / HBM_BPS * 1e3
        ops_ms = ops / peak * 1e3
        src, replaces = KERNEL_SOURCES[kname]
        report.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": cuda_ms(conv_yardstick(x, wf, tf32))})
    for k in report:
        print(f"  kernel {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']}), plain {k['plain_ms']:.4f} ms, F.conv2d "
              f"of the composed kernel {k['library_ms']:.4f} ms, max|err| vs "
              f"plain {k['max_abs_err']:.3e}")

    # Host cost of one wrapper call (argument checks, operand cache,
    # ctypes, launch) on a grid small enough that the card keeps up.
    xs = grid(HOST_SHAPE, torch.float32, seed=3)
    for kname, kern in (("stencil_direct", lambda: sd.stencil_direct(xs, w, 1)),
                        ("stencil_banded", lambda: sm.stencil_matmul(xs, w, 1))):
        print(f"  kernel {kname}: host {host_us(kern):.2f} us per launch "
              f"({HOST_SHAPE[0]}x{HOST_SHAPE[1]} float32, t=1, wall clock over "
              f"{HOST_CALLS} calls)")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch import kernels
        from repro_torch.stencil import StencilSpec, make_weights, weights
        # The package re-exports the wrapper functions under the modules'
        # names, so the modules come from importlib.
        sd = importlib.import_module("repro_torch.kernels.stencil_direct")
        sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    # The plain versions are the f32 references: no TF32 anywhere in them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = (kernels, sm, sd, weights)
    try:
        card = phase_build(kernels)
        phase_kernels_vs_plain(mods)
        x = grid(MAIN_SHAPE, torch.float32, seed=0)
        ws = {s.name: make_weights(s, seed=0)
              for s in (StencilSpec("box", 2, 1), StencilSpec("star", 2, 1))}
        results, counts = phase_main_path(mods, x, ws)
        report = phase_times(mods, x, ws, results, counts, card)
    except (SmokeFailure, RuntimeError, ValueError, TypeError,
            NotImplementedError, subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
