"""Distributed-stencil communication table (the counterpart of
``benchmarks/halo.py``: the paper's fusion-redundancy trade on the cluster
axis).

For the 16x16 decomposition of the paper's 10240^2 domain, report per-t-steps
halo traffic of stepwise vs fused execution and the redundant-compute
fraction fused execution pays (the distributed alpha) -- all analytic, from
``halo_bytes_per_step``; the stepper's own counters check it in the tests.

    PYTHONPATH=src python -m repro_torch.benchmarks.halo
"""
from __future__ import annotations

import numpy as np

from repro_torch.stencil import StencilSpec
from repro_torch.stencil.distributed import halo_bytes_per_step

CASES = [
    ("Box-2D1R", (10240 // 16, 10240 // 16), ("data", "model"), 4),
    ("Box-2D1R", (10240 // 16, 10240 // 16), ("data", "model"), 8),
    ("Star-2D3R", (10240 // 16, 10240 // 16), ("data", "model"), 2),
    ("Box-3D1R", (1024 // 16, 1024 // 16, 1024), ("data", "model", None), 4),
]


def run() -> list[str]:
    # Total halo BYTES per t steps are about equal between the modes (t
    # small exchanges against one deep one); what fused execution buys is
    # a t-fold cut in exchange ROUNDS (latency and per-message cost),
    # paid for with redundant halo compute -- the distributed alpha.
    out = ["halo.pattern,t,exchange_rounds_stepwise,exchange_rounds_fused,"
           "round_ratio,halo_bytes_per_t_steps,redundant_compute_frac"]
    for name, local, dims, t in CASES:
        spec = StencilSpec.from_name(name)
        r = spec.radius
        bf = halo_bytes_per_step(local, dims, r, t, "fused", 4)
        # redundant compute of fused mode: halo shells recomputed locally
        interior = np.prod(local)
        ext = np.prod([n + 2 * r * t if d is not None else n
                       for n, d in zip(local, dims)])
        redundant = (ext - interior) / interior
        out.append(f"halo.{name},{t},{t},1,{t}.00x,{bf},{redundant:.3f}")
    return out


if __name__ == "__main__":
    print("\n".join(run()))
