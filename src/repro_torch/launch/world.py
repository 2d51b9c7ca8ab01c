"""Local process worlds for the distributed stepper: ``run_world`` starts
``nranks`` processes on this host, joins them into one
``torch.distributed`` world and hands each a ``DeviceMesh``.

The JAX package fakes its devices inside one process
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``); PyTorch needs one
process per rank.  Each rank runs ``fn(mesh, rank, *args)``; its return
value comes back to the caller, ordered by rank.

    from repro_torch.launch.world import run_world
    results = run_world(fn, 4, mesh_shape=(2, 2), mesh_dim_names=("x", "y"))

Nothing here can hang its caller: the world rendezvouses through a
``file://`` store in a fresh directory (no TCP port, so many worlds can run
at once), every collective of the world times out after
``PG_TIMEOUT_S``, and the join is bounded by ``timeout_s``, after which every rank still
alive is killed and the call raises.  A rank that raises makes the call
raise with that rank's traceback.

Transport: ``gloo`` moves host memory only, so a rank whose shards live on
the card stages each halo slab through a pinned host buffer (the stepper
does this, ``repro_torch.stencil.distributed``).  With ``device="cuda"``
rank ``i`` uses ``cuda:(i % device_count)``: on a one-card machine every
rank shares the card, time-slicing it.  The mesh is a ``"cpu"`` device
mesh, gloo's: it names the ranks and groups, whatever device the shards
live on.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

#: The limit of one collective of a world (seconds).
PG_TIMEOUT_S = 60


def _rank_main(fn, rank, nranks, init_method, device, mesh_shape,
               mesh_dim_names, args, out) -> None:
    """One rank: join the world, build the mesh, run ``fn``, report."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            # the ranks share the host's cores, one each
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=nranks,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                    mesh_dim_names=tuple(mesh_dim_names))
            result = fn(mesh, rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, nranks: int, *, args: Sequence = (),
              mesh_shape: Optional[Sequence[int]] = None,
              mesh_dim_names: Sequence[str] = ("x",),
              device: str = "cpu", timeout_s: float = 300.0,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(mesh, rank, *args)`` on ``nranks`` spawned processes and
    return their results by rank.

    ``fn`` and ``args`` are pickled (``fn`` by import path: a module-level
    function), and so are the results: return numpy arrays, not tensors,
    whose storage torch would share with a process that has exited.  ``mesh_shape`` defaults to ``(nranks,)``; its product must
    be ``nranks``.  ``workdir`` holds the rendezvous file (default: a
    fresh temporary directory, removed afterwards).  Raises
    ``RuntimeError`` if a rank fails, and ``TimeoutError`` (after killing
    every rank still alive) if the world outlives ``timeout_s``."""
    import multiprocessing as mp

    mesh_shape = (nranks,) if mesh_shape is None else tuple(mesh_shape)
    n = 1
    for s in mesh_shape:
        n *= int(s)
    if n != nranks or len(mesh_dim_names) != len(mesh_shape):
        raise ValueError(f"mesh {mesh_shape} with names "
                         f"{tuple(mesh_dim_names)} does not hold {nranks} "
                         "ranks")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    own = workdir is None
    root = tempfile.mkdtemp(prefix="repro_world_") if own else workdir
    init_method = "file://" + os.path.join(os.path.abspath(root),
                                           f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, nranks, init_method, device,
                               mesh_shape, tuple(mesh_dim_names),
                               tuple(args), out))
             for rank in range(nranks)]
    deadline = time.monotonic() + timeout_s
    results, failures, alive_at_end = {}, {}, []
    try:
        for p in procs:
            p.start()
        # Drain the queue before joining: a rank blocks on exit until its
        # result is read.
        while len(results) + len(failures) < nranks:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died without reporting (killed, segfault):
                    # give the others a moment to report, then stop
                    deadline = min(deadline, time.monotonic() + 5.0)
                continue
            (results if ok else failures)[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                alive_at_end.append(procs.index(p))
                p.kill()
                p.join(timeout=10)
        out.close()
        if own:
            shutil.rmtree(root, ignore_errors=True)
    if failures:
        first = min(failures)
        raise RuntimeError(
            f"{len(failures)} of {nranks} ranks failed; rank {first}:\n"
            + failures[first])
    missing = [r for r in range(nranks) if r not in results]
    if missing:
        codes = {r: procs[r].exitcode for r in missing}
        if alive_at_end:
            raise TimeoutError(f"ranks {alive_at_end} did not finish within "
                               f"{timeout_s:.0f} s; they were killed")
        raise RuntimeError(f"ranks {missing} exited without a result "
                           f"(exit codes {codes})")
    return [results[r] for r in range(nranks)]
