"""Benchmark harness of the port (the counterpart of ``benchmarks/run.py``):
one module per paper table or figure, and the halo table.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
        [--device cpu] [--manifest PATH]

Runs ``table2``, ``table3``, ``table4``, ``fig10``, ``fig16``, ``halo`` and
``scaling`` (the dry run's strong scaling, read from its cached records:
only its header when there are none) and prints their CSV lines; each module documents its columns in the
header line it emits.  Every module is imported before any runs, so import
cost never leaks into a module's time; ``bench.<mod>.total`` is how long
the module took to produce its lines (host clock, bookkeeping), and
``bench.plan_cache`` the plans built and reused across the run.  Device
times inside the modules come from ``timing.time_us`` (CUDA events).
``--quick`` times fewer calls per plan in ``fig16``.  It runs on the card
unless given ``--device cpu``.

A module that fails is reported (its traceback, a ``bench.<mod>.FAILED``
line) and the others still run; the manifest (default
``BENCH_torch_run.json``) lists which modules succeeded and which failed.
Where the JAX harness exits 0 whatever failed, this one exits 1 when any
module failed, so that no failure hides behind exit code 0.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

MANIFEST_PATH = "BENCH_torch_run.json"
MODULES = ("table2", "table3", "table4", "fig10", "fig16", "halo", "scaling")
#: The arguments each module's ``run`` takes from the command line.
RUN_ARGS = {"table2": ("device",), "fig16": ("device", "quick")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.run")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--manifest", default=MANIFEST_PATH)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.benchmarks.run: no CUDA device; pass --device cpu "
              "to run the plain versions on the CPU")
        return 1
    # Import everything up front: module import cost must never leak into
    # any timed region.
    from repro_torch.benchmarks import (fig10, fig16, halo, scaling, table2,
                                        table3, table4)
    from repro_torch.kernels import plan_cache_stats

    mods = dict(table2=table2, table3=table3, table4=table4, fig10=fig10,
                fig16=fig16, halo=halo, scaling=scaling)
    opts = vars(args)
    modules = []
    for name in MODULES:
        t0 = time.perf_counter()
        try:
            lines = mods[name].run(*(opts[a] for a in RUN_ARGS.get(name, ())))
            dt = (time.perf_counter() - t0) * 1e6
            for line in lines:
                print(line)
            print(f"bench.{name}.total,{dt:.0f},us_wall")
            modules.append({"module": name, "ok": True, "wall_us": round(dt)})
        except Exception as e:  # noqa: BLE001 -- reported, the sweep goes on
            traceback.print_exc()
            print(f"bench.{name}.FAILED,0,{e}")
            modules.append({"module": name, "ok": False,
                            "error": f"{type(e).__name__}: {e}"})

    # one plan per distinct kernel signature across the whole harness;
    # hits = timed paths that reused an already-built plan
    st = plan_cache_stats()
    print(f"bench.plan_cache,{st['misses']},plans_built,{st['hits']},cache_hits")

    failed = [m["module"] for m in modules if not m["ok"]]
    with open(args.manifest, "w") as f:
        json.dump({
            "quick": args.quick,
            "device": args.device,
            "device_name": (torch.cuda.get_device_name(0)
                            if args.device == "cuda" else "cpu"),
            "modules": modules,
            "failed": failed,
            "succeeded": [m["module"] for m in modules if m["ok"]],
        }, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
