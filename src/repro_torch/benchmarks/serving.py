"""Serving benchmark: the batched plan-sharing engine against per-request
dispatch, on the card (the counterpart of ``benchmarks/serving.py``).

    python -m repro_torch.benchmarks.serving [--quick] [--grid 256,256]
                                             [--device cpu]

The engine's claim is that coalescing requests that share a plan
signature into batched launches beats dispatching each request by
itself.  This benchmark measures both sides on identical traffic and
writes BENCH_torch_serving.json (repository root):

  * **sequential baseline** -- a closed loop that, per request, looks up
    the plan (``stencil_plan``: an LRU hit after the first), copies the
    request's grid to the card, runs the plan and synchronises.  It
    already amortizes selection and the kernels' build through the plan
    cache, so the difference to the engine is *batching*, not caching.
  * **batched engine** -- the same requests through ``StencilServer``
    with a per-signature closed-loop window, so the dispatcher sees full
    queues and the coalescer emits full buckets: one copy to the card,
    one launch per kernel call (K11), one sync and one copy back per
    bucket.  Latency histograms and occupancy come from ``ServeMetrics``.

Both phases replay the same inputs; every engine response is compared
bit for bit with the sequential plan's output for that input
(``bitwise_match``): throughput that changed the answer would not count.
The plan-cache hits of the run must grow by at least requests - distinct
signatures (the plan-sharing contract).  Numbers are host wall clock
(requests/s, latency percentiles) on the device the JSON names.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.benchmarks.timing import CaseTimeout, case_budget
from repro_torch.core import events as guard_events
from repro_torch.kernels import plan_cache_stats, stencil_plan
from repro_torch.kernels.plan import resolve_device
from repro_torch.serve import LatencyHistogram, StencilServer
from repro_torch.stencil import StencilSpec, make_weights

#: The default grid: 256^2 float32 (256 KiB), one read and one write of
#: which take ~0.16 us at 3.35 TB/s -- so one request's time on the card
#: is almost all host time, the regime batching exists for.
GRID = (256, 256)
WINDOW = 128         # outstanding requests per signature (closed loop);
                     # doubles as the single batch bucket, as in JAX
N_INPUTS = 8         # distinct input grids per signature, reused round-robin
#: (shape, radius, t, dtype) per signature; quick keeps two so the
#: coalescer still has signatures to keep apart.
SIGS_FULL = [("box", 1, 1, "float32"), ("star", 1, 1, "float32"),
             ("box", 2, 1, "float32"), ("star", 3, 1, "float32")]
SIGS_QUICK = SIGS_FULL[:2]
REQS_FULL = 8192     # requests per signature (multiples of WINDOW)
REQS_QUICK = 4096
JSON_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BENCH_torch_serving.json"


@contextmanager
def _gc_quiesced():
    """Collect, then hold the cyclic GC off for one measured phase --
    applied identically to BOTH phases, as in the JAX benchmark."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


class _Workload:
    """One plan signature's traffic: weights, host inputs, reference
    outputs."""

    def __init__(self, shape: str, r: int, t: int, dtype: str, grid, rng):
        self.spec = StencilSpec(shape, len(grid), r)
        self.t = t
        self.dtype_name = dtype
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.weights = make_weights(self.spec, seed=r)
        # HOST tensors, as a serving client holds them
        self.xs = [torch.from_numpy(rng.normal(size=grid).astype(np.float32))
                   .to(dt) for _ in range(N_INPUTS)]
        self.y_ref = None            # filled by the sequential phase

    @property
    def name(self) -> str:
        return f"{self.spec.name}-t{self.t}-{self.dtype_name}"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_sequential(workloads, n_requests: int, grid, dev):
    """Per-request dispatch: plan lookup + copy + execute + sync, one at a
    time, interleaved across signatures.  Also produces the bitwise
    reference outputs (one unbatched plan call per distinct input, on the
    host)."""
    for wl in workloads:                       # warmup: build + references
        plan = stencil_plan(wl.weights, grid, wl.xs[0].dtype, wl.t,
                            device=dev)
        wl.y_ref = [plan(x.to(dev)).cpu() for x in wl.xs]

    hist = LatencyHistogram()
    t0 = time.perf_counter()
    for i in range(n_requests):
        wl = workloads[i % len(workloads)]
        r0 = time.perf_counter()
        plan = stencil_plan(wl.weights, grid, wl.xs[0].dtype, wl.t,
                            device=dev)
        plan(wl.xs[i % N_INPUTS].to(dev))
        _sync(dev)
        hist.record(time.perf_counter() - r0)
    wall = time.perf_counter() - t0
    return {"requests": n_requests, "wall_s": wall,
            "requests_per_s": n_requests / wall,
            "latency": hist.snapshot()}


def _run_batched(workloads, n_requests: int, dev, window: int = WINDOW):
    """The same traffic through the engine, issued as double-buffered
    bursts: each burst submits one full window per signature, and two
    bursts stay in flight -- while the client blocks on burst N's results,
    the dispatcher executes burst N+1's full buckets.  Returns the metrics
    snapshot plus the bitwise verdict."""
    per_sig = n_requests // len(workloads)
    rounds = per_sig // window
    # buckets pin the launch size to the window; max_batch is the drain's
    # fill target, so it counts the whole interleaved queue -- one window
    # PER signature -- or mixed drains would split into half-empty buckets
    with StencilServer(device=dev, buckets=(window,),
                       max_batch=window * len(workloads)) as server:
        # warmup: one full window per signature builds the batched plan
        done = [server.submit(wl.weights, wl.xs[i % N_INPUTS], t=wl.t)
                for wl in workloads for i in range(window)]
        for fut in done:
            fut.result()
        server.metrics.reset()                 # keep plans, drop the stats

        pending = deque()
        results = []
        issued = 0
        t0 = time.perf_counter()
        while issued < rounds or pending:
            while issued < rounds and len(pending) < 2:
                base = issued * window
                pending.append(
                    [(k, base + j,
                      server.submit(wl.weights,
                                    wl.xs[(base + j) % N_INPUTS], t=wl.t))
                     for k, wl in enumerate(workloads)
                     for j in range(window)])
                issued += 1
            for k, i, fut in pending.popleft():
                results.append((k, i, fut.result()))
        wall = time.perf_counter() - t0
        snap = server.stats()
    # bitwise audit OUTSIDE the timed window
    snap["wall_s"] = wall
    snap["bitwise_match"] = all(
        torch.equal(y, workloads[k].y_ref[i % N_INPUTS])
        for k, i, y in results)
    return snap


def run(quick: bool, grid=GRID, device=None, requests_per_signature=None,
        passes: int = 2, json_path=JSON_PATH) -> dict:
    """Both phases, ``passes`` alternating measurement passes, best of
    each side; returns the payload (written to ``json_path`` unless
    None)."""
    dev = resolve_device(device)
    grid = tuple(int(n) for n in grid)
    sig_defs = SIGS_QUICK if quick else SIGS_FULL
    per_sig = requests_per_signature or (REQS_QUICK if quick else REQS_FULL)
    rng = np.random.default_rng(0)
    workloads = [_Workload(*s, grid, rng) for s in sig_defs]
    n_requests = per_sig * len(workloads)

    pc0 = plan_cache_stats()
    seq_passes, bat_passes = [], []
    for _ in range(passes):
        with _gc_quiesced():
            seq_passes.append(_run_sequential(workloads, n_requests, grid,
                                              dev))
        with _gc_quiesced():
            bat_passes.append(_run_batched(workloads, n_requests, dev))
    pc1 = plan_cache_stats()
    seq = max(seq_passes, key=lambda s: s["requests_per_s"])
    batched = max(bat_passes, key=lambda b: b["requests_per_s"])
    batched["bitwise_match"] = all(b["bitwise_match"] for b in bat_passes)
    batched["degraded_batches"] = max(b["degraded_batches"]
                                      for b in bat_passes)
    batched["failed"] = max(b["failed"] for b in bat_passes)

    payload = {
        "quick": quick, "grid": list(grid), "window": WINDOW,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "requests_per_signature": per_sig,
        "signatures": [wl.name for wl in workloads],
        "sequential": seq,
        "batched": batched,
        "speedup": batched["requests_per_s"] / seq["requests_per_s"]
                   if seq["requests_per_s"] else 0.0,
        "bitwise_match": batched.pop("bitwise_match"),
        "plan_cache": {
            "before": pc0, "after": pc1,
            "hits_delta": pc1["hits"] - pc0["hits"],
            "misses_delta": pc1["misses"] - pc0["misses"],
        },
        # any guard event means a serving batch silently degraded
        "guard_events": guard_events.snapshot(),
    }
    if json_path is not None:
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


def summary(payload: dict) -> list:
    """The CSV lines the CLI prints."""
    seq, batched = payload["sequential"], payload["batched"]
    blat = batched["latency"]
    return ["serving.metric,device,seq_rps,batched_rps,speedup,b_p50_ms,"
            "b_p99_ms,occupancy,bitwise",
            f"serving.{'quick' if payload['quick'] else 'full'},"
            f"{payload['device']},"
            f"{seq['requests_per_s']:.0f},{batched['requests_per_s']:.0f},"
            f"{payload['speedup']:.2f}x,{blat['p50_ms']:.3f},"
            f"{blat['p99_ms']:.3f},{batched['batch_occupancy']:.2f},"
            f"{'OK' if payload['bitwise_match'] else 'MISMATCH'}"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.serving")
    ap.add_argument("--quick", action="store_true",
                    default=bool(os.environ.get("BENCH_QUICK")),
                    help="trimmed sweep (also via BENCH_QUICK=1)")
    ap.add_argument("--grid", default=",".join(map(str, GRID)),
                    help="comma-separated grid shape (default 256,256)")
    ap.add_argument("--device", default=None,
                    help="where the plans run (default: the card)")
    args = ap.parse_args(argv)
    try:
        grid = tuple(int(n) for n in args.grid.split(","))
    except ValueError:
        ap.error(f"--grid must be comma-separated integers, got {args.grid!r}")
    try:
        with case_budget():
            payload = run(args.quick, grid, args.device)
    except CaseTimeout as e:
        print(f"serving: benchmark timed out ({e})", file=sys.stderr)
        raise SystemExit(1)
    print("\n".join(summary(payload)))


if __name__ == "__main__":
    main()
