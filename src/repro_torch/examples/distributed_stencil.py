"""Distributed stencil with halo exchange on a local world of ranks (the
counterpart of ``examples/distributed_stencil.py``).

Shows the paper's temporal-fusion trade at cluster scale: fused execution
does ONE deep halo exchange per t steps (against t shallow ones), paying
with redundant halo compute -- the distributed alpha.  The example starts
its own ranks (``repro_torch.launch.world``, a ``gloo`` world) and counts
the exchange rounds with the stepper's own counter, where the JAX example
counts collective-permutes in the compiled HLO.

    PYTHONPATH=src python -m repro_torch.examples.distributed_stencil \\
        --ranks 4 --device cpu

It runs on the card unless given ``--device cpu``; on one card every rank
shares it and the halos pass through host memory (gloo).
"""
from __future__ import annotations

import argparse

import numpy as np


def mesh_shape(ranks: int) -> tuple:
    """A 2D mesh (ranks/2, 2) for an even count of at least 4, else 1D."""
    return (ranks // 2, 2) if ranks >= 4 and ranks % 2 == 0 else (ranks,)


def _rank(mesh, rank, device_type, n, t):
    import torch
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    from repro_torch.stencil.distributed import gather_shards, shard_of

    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, n))
                         .astype(np.float32)).to(device_type)
    spec = tuple(mesh.mesh_dim_names) + (None,) * (2 - mesh.ndim)
    ref = None
    if rank == 0:
        ref = stencil_plan(w, (n, n), torch.float32, t, backend="reference",
                           device=x.device)(x).cpu()
    rows = []
    for mode in ("stepwise", "fused"):
        # One plan object drives local AND distributed execution: mesh +
        # shard_spec route it through the halo-exchange stepper, with the
        # exchange schedule planned at build time (plan.halo_plan).
        plan = stencil_plan(w, (n, n), torch.float32, t, mesh=mesh,
                            shard_spec=spec, dist_mode=mode, device=x.device)
        plan.fn.reset_stats()
        y = plan(shard_of(x, mesh, spec))
        full = gather_shards(y, mesh, spec, (n, n))
        err = None if full is None else float((full - ref).abs().max())
        rows.append((mode, plan.backend, err, plan.fn.stats["rounds"],
                     plan.halo_plan["halo_bytes_per_call"],
                     plan.halo_plan["transport"]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.distributed_stencil")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--t", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to run the "
                             "kernels' plain versions on the CPU")
    from repro_torch.launch.world import run_world

    shape = mesh_shape(args.ranks)
    names = ("x", "y")[:len(shape)]
    print(f"domain {args.n}x{args.n} over mesh "
          f"{dict(zip(names, shape))} ({args.device}); Box-2D1R, t={args.t}")
    rows = run_world(_rank, args.ranks, args=(args.device, args.n, args.t),
                     mesh_shape=shape, mesh_dim_names=names,
                     device=args.device)[0]
    for mode, backend, err, rounds, hb, transport in rows:
        print(f"  {mode:9s}: {backend}, max|err|={err:.1e}  "
              f"exchange rounds={rounds}  halo-bytes/shard/{args.t}steps={hb}")
    print(f"transport: {rows[0][5]}")
    print("fused mode: 1 exchange round instead of t -- latency amortized,")
    print("halo overlap recomputed locally (the paper's alpha, distributed).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
