"""Distributed plans (``stencil_plan(mesh=, shard_spec=, dist_mode=)``), the
guard on them and the fault sweep's distributed legs, against the JAX
package: the same numpy inputs through the port's mesh plans on a 4-rank
``gloo`` world on the CPU and through JAX's mesh plans on 4 fake XLA host
devices (one subprocess), in every mode; ``halo_plan`` equal to JAX's; the
refusals with JAX's messages; the plan cache; the audit exemption; the
``halo`` fault landing every rank on JAX's rung with cause ``halo``; a real
gloo failure classified as ``halo``; the example and the ``boundary`` leg.

Every case runs in ONE world and ONE JAX subprocess (module-scoped
fixtures, started together).  The world has a 60 s collective timeout, a
``file://`` store under ``tmp_path`` and a bounded join.  Tolerance against
JAX: 1e-5 * t * max|x|."""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.launch.world import run_world
from repro_torch.stencil import StencilSpec, jacobi_weights, make_weights
from repro_torch.stencil import distributed as tdist

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

MESH22 = ([2, 2], ["x", "y"])
RING = ([4], ["i"])
#: The keys of JAX's halo_plan (the port's adds "transport").
JAX_HALO_KEYS = ("mode", "halo_depth", "exchanges_per_call",
                 "halo_bytes_per_call", "local_shape", "interior_fraction")


def _case(cid, kind, d, r, shape, t, mode, spec, mesh, backend,
          boundary=None, jacobi=False, seed=0):
    return dict(id=cid, kind=kind, d=d, r=r, shape=list(shape), t=t,
                mode=mode, spec=list(spec), mesh=mesh[0], names=mesh[1],
                backend=backend, boundary=boundary, jacobi=jacobi, seed=seed)


def _cases():
    out = []
    for mode in ("stepwise", "fused"):
        for be in (None, "fused_direct", "fused_matmul_reuse", "reference"):
            out.append(_case(f"2x2-box1-{mode}-{be or 'auto'}", "box", 2, 1,
                             (64, 64), 2, mode, ("x", "y"), MESH22, be,
                             seed=3))
        out.append(_case(f"2x2-star2-{mode}-auto", "star", 2, 2, (64, 64), 2,
                         mode, ("x", "y"), MESH22, None, seed=4))
        out.append(_case(f"3d-2x2-box1-{mode}-auto", "box", 3, 1,
                         (16, 32, 32), 2, mode, ("x", "y", None), MESH22,
                         None, seed=3))
    # JAX's test_plan_level_overlap_halo_plan, and its stepwise twin.
    for mode in ("stepwise", "overlap"):
        for be in ("fused_direct", None):
            out.append(_case(f"ring-reflect-{mode}-{be or 'auto'}", "box", 2,
                             1, (64, 64), 2, mode, ("i", None), RING, be,
                             boundary=["reflect", "periodic"], jacobi=True,
                             seed=6))
    out.append(_case("ring-3d-z-overlap-auto", "box", 3, 1, (32, 16, 16), 2,
                     "overlap", ("i", None, None), RING, None, seed=2))
    return out


CASES = _cases()
BY_ID = {c["id"]: c for c in CASES}

#: Refusals with JAX's messages: (name, grid, spec, mesh, mode, boundary).
REFUSALS = [
    ("not-divisible", [63, 64], ["x", "y"], MESH22, "fused", None),
    ("fused-nonperiodic", [64, 64], ["i", None], RING, "fused", "reflect"),
    ("overlap-two-dims", [64, 64], ["x", "y"], MESH22, "overlap", None),
    ("spec-rank", [64, 64], ["x"], MESH22, "fused", None),
]
#: The guarded legs: (name, mode, boundary).
GUARDED = [("halo", "fused", None),
           ("boundary", "stepwise", ["reflect", "periodic"])]


def _inputs(case):
    spec = StencilSpec(case["kind"], case["d"], case["r"])
    w = jacobi_weights(spec) if case["jacobi"] else \
        make_weights(spec, seed=case["seed"])
    x = np.random.default_rng(case["seed"]).normal(
        size=case["shape"]).astype(np.float32)
    return w, x


def _guard_inputs():
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    return w, x


def _opt(b):
    return None if b is None else tuple(b)


# ---------------------------------------------------------------------------
# The port's world
# ---------------------------------------------------------------------------
def _plan_rank(mesh, rank, cases):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels.guard import classify_failure
    from repro_torch.testing import faults

    meshes = {}

    def get_mesh(shape, names):
        key = (tuple(shape), tuple(names))
        if key not in meshes:             # every rank builds them in order
            meshes[key] = init_device_mesh("cpu", key[0],
                                           mesh_dim_names=key[1])
        return meshes[key]

    out = dict(grids={}, halo={}, explain={}, rounds={}, backend={})
    for c in cases:
        m = get_mesh(c["mesh"], c["names"])
        w, x = _inputs(c)
        spec = tuple(c["spec"])
        plan = tk.stencil_plan(w, c["shape"], torch.float32, c["t"],
                               mesh=m, shard_spec=spec, dist_mode=c["mode"],
                               backend=c["backend"],
                               boundary=_opt(c["boundary"]), device="cpu")
        plan.fn.reset_stats()
        y = plan(tdist.shard_of(torch.from_numpy(x), m, spec))
        full = tdist.gather_shards(y, m, spec, c["shape"])
        out["halo"][c["id"]] = dict(plan.halo_plan)
        out["explain"][c["id"]] = plan.explain()
        out["rounds"][c["id"]] = plan.fn.stats["rounds"]
        out["backend"][c["id"]] = plan.backend
        if rank == 0:
            out["grids"][c["id"]] = full.numpy()

    # The plan cache: the same signature hits, a local one is another plan.
    c = BY_ID["2x2-box1-fused-auto"]
    m = get_mesh(c["mesh"], c["names"])
    w, x = _inputs(c)
    before = tk.plan_cache_stats()
    first = tk.stencil_plan(w, c["shape"], torch.float32, c["t"], mesh=m,
                            shard_spec=("x", "y"), device="cpu")
    again = tk.stencil_plan(w, c["shape"], torch.float32, c["t"], mesh=m,
                            shard_spec=("x", "y"), dist_mode="fused",
                            device="cpu")
    local = tk.stencil_plan(w, c["shape"], torch.float32, c["t"],
                            device="cpu")
    hits = tk.plan_cache_stats()["hits"] - before["hits"]
    y = again.run(tdist.shard_of(torch.from_numpy(x), m, ("x", "y")), 2)
    y = tdist.gather_shards(y, m, ("x", "y"), c["shape"])
    out["cache"] = dict(
        hits=hits, same=first is again, local_distinct=local is not again,
        run2=None if y is None else y.numpy())
    audited = tk.stencil_plan(w, c["shape"], torch.float32, c["t"], mesh=m,
                              shard_spec=("x", "y"), device="cpu",
                              audit=True, use_cache=False)
    rep = audited.audit_report
    out["audit"] = (rep.exempt, rep.ok, len(rep.checks))
    try:
        audited(torch.zeros(c["shape"]))
    except ValueError as e:
        out["wrong_shape"] = str(e)

    out["refusals"] = {}
    for name, shape, spec, msh, mode, b in REFUSALS:
        try:
            tk.stencil_plan(w, shape, torch.float32, 2,
                            mesh=get_mesh(*msh), shard_spec=tuple(spec),
                            dist_mode=mode, boundary=b, device="cpu")
        except ValueError as e:
            out["refusals"][name] = str(e)

    # REPRO_FAULTS=halo: the first exchange fails on every rank; every
    # rank must land on the same rung, with cause "halo".
    out["guarded"] = {}
    ring = get_mesh(*RING)
    w, x = _guard_inputs()
    for name, mode, b in GUARDED:
        os.environ["REPRO_FAULTS"] = "halo"
        faults.reset_faults()
        try:
            g = tk.guarded_stencil_plan(
                w, (64, 64), torch.float32, 2, mesh=ring,
                shard_spec=("i", None), dist_mode=mode,
                backend="fused_direct", boundary=_opt(b), device="cpu")
            y = g(tdist.shard_of(torch.from_numpy(x), ring, ("i", None)))
        finally:
            del os.environ["REPRO_FAULTS"]
            faults.reset_faults()
        full = tdist.gather_shards(y, ring, ("i", None), (64, 64))
        out["guarded"][name] = dict(
            rung=g.rung, causes=[h["cause"] for h in g.history],
            grid=None if full is None else full.numpy())

    # A real gloo failure: ranks 1-3 leave the world; rank 0's exchange
    # with them fails, is classified "halo", and the guard's ladder ends
    # in an error (no exchange failure is swallowed).
    if rank != 0:
        return out
    time.sleep(1.0)
    step = tdist.make_distributed_stepper(ring, ("i", None), w, t=1,
                                          mode="fused")
    try:
        step(torch.zeros(16, 64))
    except Exception as e:  # noqa: BLE001 -- the classification is tested
        out["gloo_failure"] = (type(e).__name__, classify_failure(e).cause)
    g = tk.guarded_stencil_plan(w, (64, 64), torch.float32, 1, mesh=ring,
                                shard_spec=("i", None), dist_mode="fused",
                                backend="fused_direct", device="cpu",
                                use_cache=False)
    try:
        g(torch.zeros(16, 64))
    except tk.GuardedExecutionError as e:
        out["guard_gloo"] = [h["cause"] for h in e.history]
    return out


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.kernels import guarded_stencil_plan, stencil_plan
    from repro.stencil import StencilSpec, jacobi_weights, make_weights
    from repro.testing import faults

    cases, refusals, guarded = json.load(open(sys.argv[1]))
    devs = np.array(jax.devices()[:4])

    def mesh_of(shape, names):
        return Mesh(devs.reshape(shape), tuple(names))

    def opt(b):
        return None if b is None else tuple(b)

    grids, halo, msgs, rungs = {}, {}, {}, {}
    for c in cases:
        mesh = mesh_of(c["mesh"], c["names"])
        spec = StencilSpec(c["kind"], c["d"], c["r"])
        w = jacobi_weights(spec) if c["jacobi"] else \\
            make_weights(spec, seed=c["seed"])
        x = np.random.default_rng(c["seed"]).normal(
            size=c["shape"]).astype(np.float32)
        sp = tuple(c["spec"])
        xs = jax.device_put(x, NamedSharding(mesh, P(*sp)))
        plan = stencil_plan(w, tuple(c["shape"]), np.float32, c["t"],
                            mesh=mesh, shard_spec=sp, dist_mode=c["mode"],
                            backend="reference", boundary=opt(c["boundary"]))
        grids[c["id"]] = np.asarray(plan(xs))
        halo[c["id"]] = {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in plan.halo_plan.items()}
    w = make_weights(StencilSpec("box", 2, 1), seed=3)
    for name, shape, sp, msh, mode, b in refusals:
        try:
            stencil_plan(w, tuple(shape), np.float32, 2,
                         mesh=mesh_of(*msh), shard_spec=tuple(sp),
                         dist_mode=mode, boundary=b)
        except ValueError as e:
            msgs[name] = str(e)
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    ring = mesh_of([4], ["i"])
    xs = jax.device_put(x, NamedSharding(ring, P("i", None)))
    for name, mode, b in guarded:
        os.environ["REPRO_FAULTS"] = "halo"
        faults.reset_faults()
        g = guarded_stencil_plan(w, (64, 64), np.float32, 2, mesh=ring,
                                 shard_spec=("i", None), dist_mode=mode,
                                 backend="fused_direct", boundary=opt(b))
        y = g(xs)
        del os.environ["REPRO_FAULTS"]
        faults.reset_faults()
        rungs[name] = dict(rung=g.rung,
                           causes=[h["cause"] for h in g.history])
        grids["guarded-" + name] = np.asarray(y)
    np.savez(sys.argv[2], **grids)
    json.dump(dict(halo=halo, msgs=msgs, rungs=rungs),
              open(sys.argv[3], "w"))
""")


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("distplan")
    cfile = tmp / "cases.json"
    cfile.write_text(json.dumps([CASES, REFUSALS, GUARDED]))
    env = dict(os.environ)
    # 4 fake devices; one thread each, as the port's ranks have
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(cfile), str(tmp / "out.npz"),
         str(tmp / "out.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = run_world(_plan_rank, 4, args=(CASES,), mesh_shape=(4,),
                         mesh_dim_names=("i",), device="cpu",
                         timeout_s=300, workdir=str(tmp))
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"JAX side failed:\n{out}\n{err}"
    with np.load(tmp / "out.npz") as z:
        jgrids = {k: z[k] for k in z.files}
    return port, jgrids, json.loads((tmp / "out.json").read_text())


def _tol(case, x):
    return 1e-5 * case["t"] * float(np.abs(x).max())


# ---------------------------------------------------------------------------
# Plans in every mode against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cid", list(BY_ID))
def test_plan_matches_jax(sides, cid):
    port, jgrids, _ = sides
    case = BY_ID[cid]
    _, x = _inputs(case)
    np.testing.assert_allclose(port[0]["grids"][cid], jgrids[cid], rtol=0,
                               atol=_tol(case, x))


@pytest.mark.parametrize("cid", list(BY_ID))
def test_halo_plan_equals_jax(sides, cid):
    port, _, jout = sides
    want = jout["halo"][cid]
    for r in port:
        hp = r["halo"][cid]
        assert set(hp) - {"transport"} == set(want) <= set(JAX_HALO_KEYS)
        for k, v in want.items():
            got = list(hp[k]) if isinstance(hp[k], tuple) else hp[k]
            assert got == v, (k, got, v)
        assert hp["transport"] == "gloo"


@pytest.mark.parametrize("cid", list(BY_ID))
def test_exchange_rounds_and_explain(sides, cid):
    port = sides[0]
    case = BY_ID[cid]
    for r in port:
        hp = r["halo"][cid]
        assert r["rounds"][cid] == hp["exchanges_per_call"] == \
            (1 if case["mode"] == "fused" else case["t"])
        text = r["explain"][cid]
        assert "halo plan: mode=" + case["mode"] in text
        assert "transport: gloo" in text
        assert ("interior_fraction" in text) == (case["mode"] == "overlap")
        if case["backend"] is not None:
            assert r["backend"][cid] == case["backend"]


@pytest.mark.parametrize("be", ["fused_direct", "auto"])
def test_plan_overlap_equals_stepwise_bit_for_bit(sides, be):
    grids = sides[0][0]["grids"]
    assert np.array_equal(grids[f"ring-reflect-overlap-{be}"],
                          grids[f"ring-reflect-stepwise-{be}"])


def test_reference_backend_equals_the_oracle_bit_for_bit(sides):
    """The stepper's plain update sums in the oracle's tap order."""
    from repro_torch.stencil.reference import apply_stencil_steps
    for mode in ("stepwise", "fused"):
        case = BY_ID[f"2x2-box1-{mode}-reference"]
        w, x = _inputs(case)
        ref = apply_stencil_steps(torch.from_numpy(x), w, case["t"]).numpy()
        assert np.array_equal(sides[0][0]["grids"][case["id"]], ref)


# ---------------------------------------------------------------------------
# Refusals, cache, audit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [r[0] for r in REFUSALS])
def test_refusals_match_jax(sides, name):
    port, _, jout = sides
    for r in port:
        assert r["refusals"][name] == jout["msgs"][name]


def test_batch_with_a_mesh_and_mesh_without_spec_match_jax():
    pytest.importorskip("jax")
    from repro.kernels import stencil_plan as jplan
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    for kw in (dict(batch=2, mesh=object(), shard_spec=("x", None)),
               dict(mesh=object())):
        with pytest.raises(ValueError) as pe:
            tk.stencil_plan(w, (16, 16), torch.float32, 1, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jplan(w, (16, 16), np.float32, 1, **kw)
        assert str(pe.value) == str(je.value)


def test_plan_cache(sides):
    port = sides[0]
    case = BY_ID["2x2-box1-fused-auto"]
    w, x = _inputs(case)
    for r in port:
        c = r["cache"]
        # the first fetch and the second both hit the plan the case built
        assert c["hits"] == 2 and c["same"] and c["local_distinct"]
    from repro_torch.stencil.reference import apply_stencil_steps
    ref = apply_stencil_steps(torch.from_numpy(x), w, 2 * case["t"])
    np.testing.assert_allclose(port[0]["cache"]["run2"], ref.numpy(),
                               rtol=0, atol=_tol(case, x) * 2)


def test_audit_exempts_a_mesh_plan_as_jax_does(sides):
    import inspect
    from repro.kernels import plan as jplan
    for r in sides[0]:
        exempt, ok, nchecks = r["audit"]
        assert exempt == ("distributed stepper wraps the launch in halo "
                          "collectives") and ok and nchecks == 0
        assert exempt.split()[0] in inspect.getsource(jplan._attach_audit)
        assert "local shard (16, 64)" in r["wrong_shape"] or \
            "local shard (32, 32)" in r["wrong_shape"]


# ---------------------------------------------------------------------------
# The guard on distributed plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [g[0] for g in GUARDED])
def test_halo_fault_lands_every_rank_on_jax_rung(sides, name):
    port, jgrids, jout = sides
    want = jout["rungs"][name]
    assert want["causes"] == ["halo"]
    for r in port:
        got = r["guarded"][name]
        assert got["causes"] == ["halo"]
        assert got["rung"] == want["rung"] == "fused_direct+degraded"
    w, x = _guard_inputs()
    b = dict((g[0], g[2]) for g in GUARDED)[name]
    ref = tk.stencil_plan(w, (64, 64), torch.float32, 2, backend="reference",
                          boundary=_opt(b), device="cpu")(torch.from_numpy(x))
    grid = port[0]["guarded"][name]["grid"]
    assert np.array_equal(grid, ref.numpy())
    np.testing.assert_allclose(grid, jgrids["guarded-" + name], rtol=0,
                               atol=2e-5 * float(np.abs(x).max()))


def test_a_gloo_failure_is_a_halo_failure_and_is_not_swallowed(sides):
    r0 = sides[0][0]
    name, cause = r0["gloo_failure"]
    assert cause == "halo", name
    assert r0["guard_gloo"] and set(r0["guard_gloo"]) == {"halo"}


@pytest.mark.parametrize("msg", [
    "[../third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection closed "
    "by peer [127.0.0.1]:39834",
    "[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81] Timed out "
    "waiting 60000ms for recv operation to complete",
    "injected fault: halo exchange failed"])
def test_exchange_errors_classify_as_halo(msg):
    from repro_torch.kernels.guard import HaloExchangeError, classify_failure
    assert isinstance(classify_failure(RuntimeError(msg)), HaloExchangeError)
    assert isinstance(classify_failure(torch.distributed.DistBackendError(
        "backend refused")), HaloExchangeError)


def test_fault_sweep_boundary_leg_passes_on_the_cpu():
    from repro_torch.testing import fault_sweep
    assert fault_sweep.main(["--device", "cpu", "boundary"]) == 0


def test_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import distributed_stencil as ex
    assert ex.mesh_shape(4) == (2, 2) and ex.mesh_shape(2) == (2,)
    assert ex.main(["--ranks", "2", "--device", "cpu", "--n", "64",
                    "--t", "2"]) == 0
    out = capsys.readouterr().out
    assert "stepwise : fused_direct, max|err|=0.0e+00  exchange rounds=2" \
        in out
    assert "fused    : fused_direct, max|err|=0.0e+00  exchange rounds=1" \
        in out
