"""Strong scaling across the two production meshes, from the port's cached
dry-run records (the counterpart of ``benchmarks/scaling.py``): per cell
the single-pod (256 H100 ranks) against the multi-pod (512 ranks) roofline
terms, the parallel efficiency of the dominant term, and whether the pod
axis paid for itself.  No tracing -- reads results/dryrun_torch/*.json."""
from __future__ import annotations

import glob
import json
import os

DRY = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")


def run() -> list[str]:
    recs = {}
    for f in glob.glob(os.path.join(DRY, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok") and not r.get("tag"):
            recs[(r["arch"], r["cell"], r["mesh"])] = r["roofline"]
    out = ["scaling.arch,cell,dom_single_ms,dom_multi_ms,speedup,"
           "ideal,parallel_efficiency"]
    for (arch, cell, mesh), t in sorted(recs.items()):
        if mesh != "single":
            continue
        m = recs.get((arch, cell, "multi"))
        if not m:
            continue
        dom_s = max(t["compute_s"], t["memory_s"], t["collective_s"])
        dom_m = max(m["compute_s"], m["memory_s"], m["collective_s"])
        if dom_m <= 0:
            continue
        speed = dom_s / dom_m
        eff = speed / 2.0          # ideal strong scaling 256 -> 512 = 2x
        out.append(f"scaling.{arch},{cell},{dom_s*1e3:.1f},{dom_m*1e3:.1f},"
                   f"{speed:.2f}x,2.00x,{eff:.0%}")
    return out


if __name__ == "__main__":
    print("\n".join(run()))
