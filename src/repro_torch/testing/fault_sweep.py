"""Fault-injection sweep of the port's guard: every degradation-ladder rung
reachable (the counterpart of ``scripts/fault_sweep.py``).

    python -m repro_torch.testing.fault_sweep                 # all legs
    python -m repro_torch.testing.fault_sweep vmem nan        # a subset
    python -m repro_torch.testing.fault_sweep --device cpu clean compile
    REPRO_FAULTS=compile:inf \\
        python -m repro_torch.testing.fault_sweep --child compile

For each injected failure class the sweep asserts what the JAX sweep
asserts: execution completes (no raw traceback escapes the guard), the
surviving rung's output matches the reference oracle, and the recorded
cause matches the injected fault; the ``clean`` leg asserts the converse
-- with nothing armed the guarded plan IS the cached unguarded plan
object, the event log stays empty and nothing degrades.

Each leg runs in a subprocess with the fault armed through the
``REPRO_FAULTS`` environment variable, as in JAX, so plan caches and
fault counters are isolated per leg.  The legs run on the card unless
given ``--device cpu``.  Two things differ on the card, as the guard
itself does there: its ladder has no plain ``reference`` rung, so the
``compile`` and ``sparse_ladder`` legs must end in a
``GuardedExecutionError`` after the last kernel rung, and the NaN
watchdog re-runs the step on the next kernel rung; and outputs are held
to the oracle within the tap-sum limit (1e-5 per step of max|x|), not bit
for bit, because the kernels' fused multiply-adds round differently from
the plain oracle.  On the CPU the tap-sum rungs equal the oracle bit for
bit, as in JAX.

The ``halo`` and ``boundary`` legs run a distributed plan on a 2-rank
``gloo`` world (``repro_torch.launch.world``; on the card both ranks
share it and stage their halos through host memory): the armed ``halo``
fault fails the first exchange on both ranks, and both must land on the
same rung with cause ``halo`` and finish, the ``boundary`` leg on a
non-periodic (reflect x periodic) ``stepwise`` plan whose surviving rung
must still honour the boundary spec.
"""
from __future__ import annotations

import os
import subprocess
import sys

#: leg -> (REPRO_FAULTS value, extra env)
LEGS = {
    "clean": ("", {}),
    "compile": ("compile:inf", {}),
    "vmem": ("vmem", {}),
    "nan": ("nan", {"REPRO_NAN_WATCHDOG": "1"}),
    "halo": ("halo", {}),
    "boundary": ("halo", {}),
    "sparse": ("vmem", {}),
    "sparse_ladder": ("compile:inf", {}),
}

_T = 2


def _setup2d(device):
    import numpy as np
    import torch
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights

    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    ref = stencil_plan(w, x.shape, torch.float32, _T, backend="reference",
                       device=device)(xt)
    return w, xt, ref


def _matches(y, ref, label, bitwise_on_cpu=True):
    """The surviving rung against the oracle: bit for bit on the CPU
    (where the tap-sum's plain version sums in the oracle's order), and
    within the tap-sum limit on the card."""
    import torch
    if y.device.type == "cpu" and bitwise_on_cpu:
        assert torch.equal(y, ref), \
            f"{label}: surviving rung not bit-for-bit vs reference oracle"
        return
    tol = 1e-5 * _T * float(ref.abs().max())
    err = float((y.float() - ref.float()).abs().max())
    assert err <= tol, f"{label}: max|err| {err:.3e} vs oracle > {tol:.3e}"


def _ladder_end(g, x, label, device):
    """Every kernel rung fails: on the CPU the walk ends on the reference
    oracle; on the card it raises after the last kernel rung."""
    from repro_torch.kernels import GuardedExecutionError
    if device.type == "cpu":
        y = g(x)
        assert g.backend == "reference", g.rung
        assert g.history and all(h["cause"] == "compile"
                                 for h in g.history), g.history
        return y
    try:
        g(x)
    except GuardedExecutionError as e:
        rungs = [h["rung"] for h in e.history]
        assert rungs[-1] == "direct_wholestrip" and "reference" not in rungs, \
            f"{label}: walked {rungs}"
        assert all(h["cause"] == "compile" for h in e.history), e.history
        return None
    raise AssertionError(f"{label}: the card's ladder did not raise")


def leg_clean(device):
    """Nothing armed: the guard must be invisible."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels import (guarded_stencil_plan, plan_cache_stats,
                                     stencil_plan)

    w, x, ref = _setup2d(device)
    p0 = stencil_plan(w, x.shape, torch.float32, _T, backend="fused_direct",
                      device=device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_direct", device=device)
    assert g.plan is p0, "clean: guarded plan != cached unguarded plan"
    y = g(x)
    assert not g.degraded and g.history == []
    assert events.events() == [], f"clean: events {events.events()}"
    st = plan_cache_stats()
    for k in ("build_failures", "exec_failures", "fallbacks"):
        assert st[k] == 0, (k, st)
    _matches(y, ref, "clean")
    assert torch.equal(p0(x), y), "clean: guarded != unguarded output"


def leg_compile(device):
    """Every kernel build fails: the ladder bottoms out (CPU: on the
    reference oracle) with cause 'compile' at every failed rung."""
    import torch
    from repro_torch.kernels import guarded_stencil_plan

    w, x, ref = _setup2d(device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_matmul_reuse", device=device)
    y = _ladder_end(g, x, "compile", device)
    if y is not None:
        _matches(y, ref, "compile")


def leg_vmem(device):
    """One shared-memory overflow: the degraded-tile rung of the SAME
    backend must survive (budget halved, tile re-resolved)."""
    import torch
    from repro_torch.kernels import guarded_stencil_plan

    w, x, ref = _setup2d(device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_direct", device=device)
    y = g(x)
    assert g.rung == "fused_direct+degraded", g.rung
    assert [h["cause"] for h in g.history] == ["vmem"], g.history
    _matches(y, ref, "vmem")


def leg_nan(device):
    """A NaN-corrupted step: the watchdog (armed via REPRO_NAN_WATCHDOG)
    must recover THIS step (CPU: through the checked reference re-run;
    card: on the next kernel rung), record cause 'numerical', and demote
    the rung for future calls."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels import guarded_stencil_plan

    w, x, ref = _setup2d(device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_direct", device=device)
    assert g.watchdog, "REPRO_NAN_WATCHDOG=1 not honored"
    y = g(x)
    assert [h["cause"] for h in g.history] == ["numerical"], g.history
    assert events.events("guard_watchdog"), "no watchdog event recorded"
    _matches(y, ref, "nan")
    # the demoted rung keeps producing oracle-grade output
    _matches(g(x), ref, "nan-demoted")


_N = 64


def _halo_rank(mesh, rank, device_type, dist_mode, boundary):
    """One rank of the halo / boundary legs: a guarded distributed plan on
    the 2-rank mesh, run once on this rank's shard; returns the rung, the
    history and (rank 0) the gathered grid."""
    import numpy as np
    import torch
    from repro_torch.kernels import guarded_stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    from repro_torch.stencil.distributed import gather_shards, shard_of

    spec = ("x", None)
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = np.random.default_rng(0).normal(size=(_N, _N)).astype(np.float32)
    xt = torch.from_numpy(x).to(device_type)
    g = guarded_stencil_plan(w, (_N, _N), torch.float32, _T, mesh=mesh,
                             shard_spec=spec, dist_mode=dist_mode,
                             backend="fused_direct", boundary=boundary,
                             device=xt.device)
    y = g(shard_of(xt, mesh, spec))
    full = gather_shards(y, mesh, spec, (_N, _N))
    return {"rung": g.rung, "degraded": g.degraded,
            "causes": [h["cause"] for h in g.history],
            "grid": None if full is None else full.numpy()}


def _halo_world(device, label, dist_mode, boundary):
    """A failed halo exchange on a 2-rank mesh: the guard retries on the
    next rung (deterministic from the plan key, so both ranks agree) and
    the stepper completes; the gathered grid matches the oracle of the
    same boundary."""
    import numpy as np
    import torch
    from repro_torch.kernels import stencil_plan
    from repro_torch.launch.world import run_world
    from repro_torch.stencil import StencilSpec, make_weights

    res = run_world(_halo_rank, 2, args=(device.type, dist_mode, boundary),
                    mesh_dim_names=("x",), device=device.type,
                    timeout_s=600)
    for r, out in enumerate(res):
        assert out["causes"] == ["halo"], (label, r, out["causes"])
        assert out["degraded"], (label, r)
    rungs = [out["rung"] for out in res]
    assert len(set(rungs)) == 1, f"{label}: ranks landed on {rungs}"
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = np.random.default_rng(0).normal(size=(_N, _N)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    ref = stencil_plan(w, (_N, _N), torch.float32, _T, backend="reference",
                       boundary=boundary, device=device)(xt)
    _matches(torch.from_numpy(res[0]["grid"]).to(device), ref, label)


def leg_halo(device):
    """A failed halo exchange on a fused distributed plan."""
    _halo_world(device, "halo", "fused", None)


def leg_boundary(device):
    """A failed halo exchange on a NON-PERIODIC distributed plan: the
    ladder degrades exactly as on the periodic path and the surviving rung
    still honours the boundary spec (stepwise, not fused: fused refuses
    non-periodic specs)."""
    _halo_world(device, "boundary", "stepwise", ("reflect", "periodic"))


def leg_sparse(device):
    """One shared-memory overflow on the sparse-compacted rung: the
    degraded tile of the SAME sparse backend must survive -- bit for bit
    the dense banded plan on that tile (the compaction contract) and
    within the banded limit of the oracle."""
    import torch
    from repro_torch.kernels import guarded_stencil_plan, stencil_plan

    w, x, ref = _setup2d(device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_sparse_matmul", device=device)
    y = g(x)
    assert g.rung == "fused_sparse_matmul+degraded", g.rung
    assert [h["cause"] for h in g.history] == ["vmem"], g.history
    geom = g.plan.ctx.launch_geom(w, _T)
    dense = stencil_plan(w, x.shape, torch.float32, _T,
                         backend="fused_matmul_reuse", device=device,
                         tile_m=geom.strip_m, w_tile=geom.w_tile)
    assert torch.equal(y, dense(x)), \
        "sparse: surviving rung differs from the dense plan on its tile"
    tol = _T * 2**-10 * float(abs(w).sum()) * float(x.abs().max())
    err = float((y - ref).abs().max())
    assert err <= tol, f"sparse: max|err| {err:.3e} vs oracle > {tol:.3e}"


def leg_sparse_ladder(device):
    """Every kernel build fails from the sparse rung: the walk passes
    straight down the dense ladder and bottoms out (CPU: on the
    reference oracle) with cause 'compile' at every failed rung."""
    import torch
    from repro_torch.kernels import guarded_stencil_plan

    w, x, ref = _setup2d(device)
    g = guarded_stencil_plan(w, x.shape, torch.float32, _T,
                             backend="fused_sparse_matmul", device=device)
    y = _ladder_end(g, x, "sparse_ladder", device)
    if y is not None:
        _matches(y, ref, "sparse_ladder")


def run_child(leg: str, device) -> None:
    from repro_torch.kernels.plan import resolve_device
    fn = {"clean": leg_clean, "compile": leg_compile, "vmem": leg_vmem,
          "nan": leg_nan, "halo": leg_halo, "boundary": leg_boundary,
          "sparse": leg_sparse,
          "sparse_ladder": leg_sparse_ladder}[leg]
    fn(resolve_device(device))
    print(f"PASS {leg}")


def main(argv) -> int:
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    if argv[:1] == ["--child"]:
        run_child(argv[1], device)
        return 0
    legs = argv or list(LEGS)
    unknown = [leg for leg in legs if leg not in LEGS]
    if unknown:
        print(f"unknown leg(s) {unknown}; choose from {list(LEGS)}",
              file=sys.stderr)
        return 2
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    failures = []
    for leg in legs:
        faults, extra = LEGS[leg]
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("REPRO_FAULTS", None)
        if faults:
            env["REPRO_FAULTS"] = faults
        env.update(extra)
        cmd = [sys.executable, "-m", "repro_torch.testing.fault_sweep"]
        if device is not None:
            cmd += ["--device", device]
        r = subprocess.run(cmd + ["--child", leg], capture_output=True,
                           text=True, env=env, timeout=900)
        status = "PASS" if r.returncode == 0 else "FAIL"
        print(f"fault_sweep: {status} {leg} "
              f"(REPRO_FAULTS={faults or '<unset>'})")
        if r.returncode != 0:
            failures.append(leg)
            print(r.stdout, file=sys.stderr)
            print(r.stderr, file=sys.stderr)
    if failures:
        print(f"fault_sweep: FAILED legs: {failures}", file=sys.stderr)
        return 1
    print(f"fault_sweep: all {len(legs)} leg(s) passed -- every ladder "
          "rung reachable, causes recorded, outputs matching the oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
