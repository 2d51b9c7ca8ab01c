"""Serving drivers (the counterpart of ``repro.launch.serve``): the batched
stencil engine on the card, and the LLM decode loop's arguments.

``stencil`` subcommand: drive the batched plan-sharing stencil engine
(``repro_torch.serve``) with a closed-loop client -- a fixed window of
outstanding requests over one plan signature -- and report requests/s,
batch occupancy, and P50/P99 latency.  It runs on the card unless given
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve stencil \\
        --requests 256 --window 16 --shape star --t 2 --grid 256,256

Default (no subcommand): the LLM decode driver.  Its arguments parse as
the JAX driver's do, but the LLM scaffold is not ported yet (ROADMAP
queue 1, item 18), so running it raises ``NotImplementedError``.  This
module imports no LLM code.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    # The LLM driver's flags, as in JAX (whose --arch choices come from
    # the LLM configs, item 18).
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--check", action="store_true",
                    help="verify cached decode == uncached forward argmax")

    sub = ap.add_subparsers(dest="cmd")
    st = sub.add_parser(
        "stencil",
        help="batched plan-sharing stencil serving engine (repro_torch.serve)")
    st.add_argument("--requests", type=int, default=256,
                    help="total requests the closed loop issues")
    st.add_argument("--window", type=int, default=16,
                    help="closed-loop concurrency (outstanding requests)")
    st.add_argument("--shape", choices=("box", "star"), default="star")
    st.add_argument("--radius", type=int, default=1)
    st.add_argument("--t", type=int, default=2, dest="depth",
                    help="fusion depth (time steps per request)")
    st.add_argument("--grid", default="32,32",
                    help="comma-separated grid shape, e.g. 32,32 or 8,16,16")
    st.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    st.add_argument("--max-batch", type=int, default=None,
                    help="override REPRO_SERVE_MAX_BATCH")
    st.add_argument("--timeout-ms", type=int, default=None,
                    help="override REPRO_SERVE_QUEUE_TIMEOUT_MS")
    st.add_argument("--no-guard", action="store_true",
                    help="skip the guarded-execution ladder")
    st.add_argument("--device", default=None,
                    help="where the plans run (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    if getattr(args, "cmd", None) == "stencil":
        # Degenerate loop bounds die with a usage error, not a hang in the
        # closed loop.
        for name in ("requests", "window", "radius", "depth"):
            value = getattr(args, name)
            if value < 1:
                flag = {"depth": "t"}.get(name, name.replace("_", "-"))
                ap.error(f"--{flag} must be >= 1, got {value}")
        for name in ("max_batch", "timeout_ms"):
            value = getattr(args, name)
            floor = 1 if name == "max_batch" else 0
            if value is not None and value < floor:
                ap.error(f"--{name.replace('_', '-')} must be >= {floor}, "
                         f"got {value}")
        try:
            grid = tuple(int(n) for n in args.grid.split(","))
        except ValueError:
            ap.error(f"--grid must be comma-separated integers, "
                     f"got {args.grid!r}")
        if not grid or any(n < 1 for n in grid) or len(grid) > 3:
            ap.error(f"--grid needs 1-3 positive dims, got {args.grid!r}")
        args.grid_shape = grid
        return args
    # --prompt-len 0 would leave the prefill loop body unexecuted; --gen 0
    # would empty the decode loop: usage errors (status 2), as in JAX.
    for name in ("batch", "prompt_len", "gen"):
        value = getattr(args, name)
        if value < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got {value}")
    return args


def serve_stencil(args) -> dict:
    """Closed-loop drive of the batched stencil engine; returns (and
    prints) the metrics snapshot."""
    from repro_torch.serve import StencilServer
    from repro_torch.stencil.spec import StencilSpec
    from repro_torch.stencil.weights import jacobi_weights

    spec = StencilSpec(args.shape, len(args.grid_shape), args.radius)
    weights = jacobi_weights(spec)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=args.grid_shape)
                           .astype(np.float32)).to(dtype)
          for _ in range(min(args.window, args.requests))]

    with StencilServer(device=args.device, max_batch=args.max_batch,
                       queue_timeout_ms=args.timeout_ms,
                       guard=not args.no_guard) as server:
        # closed loop: keep `window` requests outstanding, issue a new one
        # as each completes; reuse the window's input tensors round-robin
        outstanding = []
        issued = 0
        t0 = time.perf_counter()
        while issued < args.requests or outstanding:
            while issued < args.requests and len(outstanding) < len(xs):
                outstanding.append(server.submit(
                    weights, xs[issued % len(xs)], t=args.depth))
                issued += 1
            outstanding.pop(0).result()
        wall = time.perf_counter() - t0
        snap = server.stats()
        device = server.device

    lat = snap["latency"]
    print(f"stencil serve: {spec.name} t={args.depth} "
          f"grid={args.grid_shape} dtype={args.dtype} "
          f"guard={not args.no_guard} device={device}")
    print(f"  requests   : {snap['responded']}/{snap['submitted']} "
          f"in {wall:.2f}s wall ({snap['responded']/wall:.0f} req/s)")
    print(f"  batches    : {snap['batches']} "
          f"(occupancy {snap['batch_occupancy']:.2f}, "
          f"degraded {snap['degraded_batches']})")
    print(f"  latency ms : p50={lat['p50_ms']:.2f} p99={lat['p99_ms']:.2f} "
          f"mean={lat['mean_ms']:.2f} max={lat['max_ms']:.2f}")
    pc = snap["plan_cache"]
    print(f"  plan cache : {pc['hits']} hits / {pc['misses']} misses "
          f"({snap['engine_plans']} engine plans)")
    return snap


def main(argv=None):
    args = parse_args(argv)
    if getattr(args, "cmd", None) == "stencil":
        serve_stencil(args)
        return
    raise NotImplementedError(
        "the LLM decode driver is not ported to PyTorch yet (ROADMAP queue "
        "1, item 18); the 'stencil' subcommand runs the stencil engine")


if __name__ == "__main__":
    main()
