"""The distributed stepper (``repro_torch.stencil.distributed``) against the
JAX package's ``repro.stencil.distributed``: the same numpy inputs through
``make_distributed_stepper`` on a 4-rank ``gloo`` world on the CPU (the
port, each rank one process) and on 4 fake XLA host devices (JAX, one
subprocess), for stepwise / fused / overlap, box / star, r in {1, 2}, 2x2
and 4-rank ring meshes, a 3D grid sharded along z, mesh dims of size 1
and non-periodic specs; the analytic halo bytes against JAX's and against
the stepper's own counters; ``overlap`` bit for bit ``stepwise`` for
every backend; the overlap schedule's independence report.

Every case runs in ONE world and ONE JAX subprocess (module-scoped
fixtures, started together); the tests assert on their results.  The world
has a 60 s collective timeout, a ``file://`` store under ``tmp_path`` and a
bounded join (``repro_torch.launch.world``).

Tolerance against JAX: 1e-5 * t * max|x| (XLA and torch form their
multiply-adds differently; the port's plain banded versions multiply in
f32 on the CPU)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.world import run_world
from repro_torch.stencil import StencilSpec, make_weights
from repro_torch.stencil import distributed as tdist

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: Local updates every case runs: the stepper's plain update (None) and
#: two kernel plans (tap-sum and banded).
LOCALS = (None, "fused_direct", "fused_matmul_reuse")
#: ... and every backend on the overlap pairs (bit for bit stepwise).
ALL = (None, "direct", "fused_direct", "matmul", "fused_matmul",
       "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul",
       "fused_direct_wholestrip", "fused_matmul_reuse_wholestrip")

MESH22 = dict(mesh=[2, 2], names=["x", "y"])
RING = dict(mesh=[4], names=["i"])


def _case(cid, kind, d, r, shape, t, mode, spec, boundary=None, mesh=MESH22,
          seed=0, pair=None):
    return dict(id=cid, kind=kind, d=d, r=r, shape=list(shape), t=t,
                mode=mode, spec=list(spec), boundary=boundary, seed=seed,
                pair=pair, **mesh)


def _cases():
    out = []
    # 2x2 mesh, both dims sharded: rings of 2 on both dims.
    for kind in ("box", "star"):
        for r in (1, 2):
            for mode in ("stepwise", "fused"):
                out.append(_case(f"2x2-{kind}{r}-{mode}", kind, 2, r,
                                 (64, 64), 3, mode, ("x", "y"), seed=r))
    # 4-rank ring along rows: overlap and its stepwise twin, periodic and
    # non-periodic (JAX's test_stepwise_modes_and_overlap_bitwise).
    # Overlap's edge blocks are only 3r deep along the sharded dim, so at
    # r in {1, 2} the local plans run on 3- and 6-deep axes (the tile
    # rule's smallest tiles; in 3D, sharded along z, 3- and 6-plane slabs).
    pairs = [("star", 1, 1, None), ("star", 1, 3, None),
             ("star", 1, 3, ["reflect", "periodic"]),
             ("star", 1, 3, ["zero", "replicate"]), ("box", 2, 2, None)]
    for kind, r, t, b in pairs:
        tag = f"ring-{kind}{r}-t{t}-{'-'.join(b) if b else 'periodic'}"
        for mode in ("stepwise", "overlap"):
            out.append(_case(f"{tag}-{mode}", kind, 2, r, (64, 96), t, mode,
                             ("i", None), b, RING, seed=5, pair=tag))
    # ... along columns (the sharded dim is the last one).
    for b in (None, ["periodic", "reflect"]):
        tag = f"ring-cols-box2-{'-'.join(b) if b else 'periodic'}"
        for mode in ("stepwise", "overlap"):
            out.append(_case(f"{tag}-{mode}", "box", 2, 2, (48, 128), 2,
                             mode, (None, "i"), b, RING, seed=6, pair=tag))
    # 3D, sharded along z.
    out.append(_case("3d-z-box1-fused", "box", 3, 1, (32, 16, 16), 2,
                     "fused", ("i", None, None), None, RING, seed=2))
    for kind, r, b in (("box", 1, None), ("box", 2, None),
                       ("star", 1, ["zero", None, "reflect"])):
        tag = f"3d-z-{kind}{r}-{'-'.join(m or 'periodic' for m in b) if b else 'periodic'}"
        for mode in ("stepwise", "overlap"):
            out.append(_case(f"{tag}-{mode}", kind, 3, r, (32, 16, 16), 2,
                             mode, ("i", None, None), b, RING, seed=2,
                             pair=tag))
    # Mesh dims of size 1: a local wrap, no P2P op on that dim.
    for shape in ([1, 4], [4, 1]):
        for mode in ("stepwise", "fused"):
            out.append(_case(f"mesh{shape[0]}x{shape[1]}-box1-{mode}", "box",
                             2, 1, (64, 64), 2, mode, ("x", "y"),
                             mesh=dict(mesh=shape, names=["x", "y"]),
                             seed=3))
    return out


CASES = _cases()
BY_ID = {c["id"]: c for c in CASES}
PAIRS = sorted({c["pair"] for c in CASES if c["pair"]})


def _backends(case):
    return ALL if case["pair"] else LOCALS


def _inputs(case):
    w = make_weights(StencilSpec(case["kind"], case["d"], case["r"]),
                     seed=case["seed"])
    x = np.random.default_rng(case["seed"]).normal(
        size=case["shape"]).astype(np.float32)
    return w, x


def _boundary(case):
    b = case["boundary"]
    return None if b is None else tuple(b)


def _local_shape(case):
    shape = list(case["shape"])
    for d, ax in enumerate(case["spec"]):
        if ax is not None:
            shape[d] //= case["mesh"][case["names"].index(ax)]
    return tuple(shape)


# ---------------------------------------------------------------------------
# The port's world
# ---------------------------------------------------------------------------
def _port_rank(mesh, rank, cases):
    """Every case on this rank; rank 0 returns the gathered grids."""
    from torch.distributed.device_mesh import init_device_mesh

    meshes = {}
    grids, stats = {}, {}
    for c in cases:
        key = (tuple(c["mesh"]), tuple(c["names"]))
        if key not in meshes:         # every rank builds them in one order
            meshes[key] = init_device_mesh("cpu", key[0],
                                           mesh_dim_names=key[1])
        m = meshes[key]
        w, x = _inputs(c)
        spec = tuple(c["spec"])
        xl = tdist.shard_of(torch.from_numpy(x), m, spec)
        for be in _backends(c):
            la = None if be is None else tdist.kernel_local_apply(be)
            step = tdist.make_distributed_stepper(
                m, spec, w, t=c["t"], mode=c["mode"], local_apply=la,
                boundary=_boundary(c))
            y = step(xl)
            assert tuple(y.shape) == tuple(xl.shape)
            full = tdist.gather_shards(y, m, spec, c["shape"])
            stats[(c["id"], be)] = step.stats
            if rank == 0:
                grids[(c["id"], be)] = full.numpy()

    ring = meshes[((4,), ("i",))]
    w, x = _inputs(BY_ID["ring-star1-t1-periodic-overlap"])
    xl = tdist.shard_of(torch.from_numpy(x), ring, ("i", None))
    reports = {
        be: tdist.overlap_independence_report(
            ring, ("i", None), w, xl,
            local_apply=None if be is None else tdist.kernel_local_apply(be))
        for be in (None, "fused_direct")}
    tdist.reset_overlap_stats()
    tdist.make_distributed_stepper(ring, ("i", None), w, t=2,
                                   mode="overlap")(xl)
    ostats = tdist.overlap_stats()

    refusals = {}
    for name, kw in (("fused-nonperiodic",
                      dict(mesh=ring, spec=("i", None), mode="fused",
                           boundary="reflect")),
                     ("overlap-two-dims",
                      dict(mesh=meshes[((2, 2), ("x", "y"))],
                           spec=("x", "y"), mode="overlap", boundary=None))):
        try:
            tdist.make_distributed_stepper(kw["mesh"], kw["spec"], w, t=2,
                                           mode=kw["mode"],
                                           boundary=kw["boundary"])
        except ValueError as e:
            refusals[name] = str(e)
    return dict(grids=grids, stats=stats, reports=reports, ostats=ostats,
                refusals=refusals)


JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.stencil import StencilSpec, make_weights
    from repro.stencil.distributed import make_distributed_stepper

    cases = json.load(open(sys.argv[1]))
    devs = np.array(jax.devices()[:4])
    out, msgs = {}, {}
    for c in cases:
        mesh = Mesh(devs.reshape(c["mesh"]), tuple(c["names"]))
        w = make_weights(StencilSpec(c["kind"], c["d"], c["r"]),
                         seed=c["seed"])
        x = np.random.default_rng(c["seed"]).normal(
            size=c["shape"]).astype(np.float32)
        spec = tuple(c["spec"])
        b = None if c["boundary"] is None else tuple(c["boundary"])
        xs = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        step = make_distributed_stepper(mesh, spec, w, t=c["t"],
                                        mode=c["mode"], boundary=b)
        with mesh:
            out[c["id"]] = np.asarray(jax.jit(step)(xs))
    w = make_weights(StencilSpec("star", 2, 1), seed=5)
    for name, mesh, spec, mode, b in (
            ("fused-nonperiodic", Mesh(devs, ("i",)), ("i", None), "fused",
             "reflect"),
            ("overlap-two-dims", Mesh(devs.reshape(2, 2), ("x", "y")),
             ("x", "y"), "overlap", None)):
        try:
            make_distributed_stepper(mesh, spec, w, t=2, mode=mode,
                                     boundary=b)
        except ValueError as e:
            msgs[name] = str(e)
    np.savez(sys.argv[2], **out)
    json.dump(msgs, open(sys.argv[3], "w"))
""")


def _start_jax(tmp, cases, script):
    pytest.importorskip("jax")
    cfile = tmp / "cases.json"
    cfile.write_text(json.dumps(cases))
    env = dict(os.environ)
    # 4 fake devices; one thread each, as the port's ranks have
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", script, str(cfile), str(tmp / "out.npz"),
         str(tmp / "msgs.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _finish_jax(proc, tmp):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"JAX side failed:\n{out}\n{err}"
    with np.load(tmp / "out.npz") as z:
        grids = {k: z[k] for k in z.files}
    return grids, json.loads((tmp / "msgs.json").read_text())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both packages on every case, the JAX subprocess running while the
    port's world does."""
    tmp = tmp_path_factory.mktemp("dist")
    proc = _start_jax(tmp, CASES, JAX_SCRIPT)
    try:
        res = run_world(_port_rank, 4, args=(CASES,), mesh_shape=(4,),
                        mesh_dim_names=("i",), device="cpu", timeout_s=300,
                        workdir=str(tmp))
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    jgrids, jmsgs = _finish_jax(proc, tmp)
    return res, jgrids, jmsgs


def _tol(case, x):
    return 1e-5 * case["t"] * float(np.abs(x).max())


# ---------------------------------------------------------------------------
# Parity with JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cid,backend", [
    (c["id"], be) for c in CASES for be in _backends(c)])
def test_stepper_matches_jax(sides, cid, backend):
    res, jgrids, _ = sides
    case = BY_ID[cid]
    _, x = _inputs(case)
    port = res[0]["grids"][(cid, backend)]
    assert port.shape == tuple(case["shape"])
    np.testing.assert_allclose(port, jgrids[cid], rtol=0,
                               atol=_tol(case, x))


@pytest.mark.parametrize("pair,backend", [(p, be) for p in PAIRS
                                          for be in ALL])
def test_overlap_equals_stepwise_bit_for_bit(sides, pair, backend):
    """On the CPU every backend's overlap step equals its stepwise step
    where the sharded dim is not the last one: each output cell sees the
    same taps in the same order.  Sharded along the last dim, the banded
    backends contract 16-column chunks whose phase follows each block's
    first column, which the interior and edge blocks shift: there they
    hold within the tolerance (ROADMAP queue 3)."""
    grids = sides[0][0]["grids"]
    sw = grids[(f"{pair}-stepwise", backend)]
    ov = grids[(f"{pair}-overlap", backend)]
    case = BY_ID[f"{pair}-overlap"]
    if case["spec"][-1] is not None and backend is not None \
            and "matmul" in backend:
        _, x = _inputs(case)
        np.testing.assert_allclose(ov, sw, rtol=0, atol=_tol(case, x))
    else:
        assert np.array_equal(sw, ov), float(np.abs(sw - ov).max())


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_stepper_counters(sides, cid):
    """Exchange rounds, ring shifts, P2P ops and halo bytes, equal on every
    rank: 1 round per call fused, t stepwise and overlap; the bytes equal
    ``halo_bytes_per_step``; a mesh dim of size 1 posts no P2P op."""
    res = sides[0]
    case = BY_ID[cid]
    t, mode = case["t"], case["mode"]
    rounds = 1 if mode == "fused" else t
    sharded = [ax for ax in case["spec"] if ax is not None]
    p2p_dims = sum(1 for ax in sharded
                   if case["mesh"][case["names"].index(ax)] > 1)
    want_bytes = tdist.halo_bytes_per_step(
        _local_shape(case), case["spec"], case["r"], t, mode, 4)
    for be in _backends(case):
        per_rank = [r["stats"][(cid, be)] for r in res]
        assert all(s == per_rank[0] for s in per_rank), per_rank
        st = per_rank[0]
        assert st["calls"] == 1
        assert st["rounds"] == rounds, st
        assert st["ring_shifts"] == 2 * len(sharded) * rounds, st
        assert st["p2p_ops"] == 4 * p2p_dims * rounds, st
        assert st["halo_bytes"] == want_bytes, (st, want_bytes)


@pytest.mark.parametrize("name", ["fused-nonperiodic", "overlap-two-dims"])
def test_stepper_refusals_match_jax(sides, name):
    res, _, jmsgs = sides
    assert res[0]["refusals"][name] == jmsgs[name]


@pytest.mark.parametrize("cid", [c["id"] for c in CASES
                                 if c["id"].startswith("mesh")])
@pytest.mark.parametrize("backend", LOCALS)
def test_size1_mesh_dim_equals_the_single_process_plan(sides, cid,
                                                       backend):
    """A mesh dim of size 1 is a local wrap: the gathered grid equals the
    undistributed periodic plan of the same backend (bit for bit for the
    tap-sums, whose cells sum in the oracle's order; the banded plain
    version chunks the columns of the extended block, so within the
    tolerance)."""
    from repro_torch.kernels import stencil_plan
    case = BY_ID[cid]
    w, x = _inputs(case)
    plan = stencil_plan(w, case["shape"], torch.float32, case["t"],
                        backend=backend or "reference", device="cpu")
    want = plan(torch.from_numpy(x)).numpy()
    got = sides[0][0]["grids"][(cid, backend)]
    if backend == "fused_matmul_reuse":
        np.testing.assert_allclose(got, want, rtol=0, atol=_tol(case, x))
    else:
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Overlap schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", [None, "fused_direct"])
def test_overlap_independence_report(sides, backend):
    for r in sides[0]:
        rep = r["reports"][backend]
        assert rep["interior_independent"], rep
        assert rep["ppermute_eqns"] == 2 and rep["p2p_ops"] == 4, rep
        assert rep["reassembly_concats"] == 1, rep
        assert rep["interior_before_wait"] and not rep["interior_reads_recv"]


def test_overlap_stats(sides):
    for r in sides[0]:
        st = r["ostats"]
        assert st["overlap_steps"] == 2, st
        assert st["interior_before_recv_consumed"] >= 2, st
        assert st["edge_launches"] == 2 * st["overlap_steps"], st
        assert st["exchanges_issued"] == st["interior_launches"] == 2, st


def test_overlap_report_keys_follow_jax(sides):
    """The report takes JAX's arguments and answers by JAX's keys."""
    import inspect
    pytest.importorskip("jax")
    from repro.stencil import distributed as jdist
    assert inspect.signature(jdist.overlap_independence_report).parameters \
        .keys() == inspect.signature(
            tdist.overlap_independence_report).parameters.keys()
    keys = {"ppermute_eqns", "mixed_concats", "reassembly_concats",
            "interior_independent"}
    for r in sides[0]:
        assert keys <= r["reports"][None].keys()


# ---------------------------------------------------------------------------
# Halo bytes (pure arithmetic)
# ---------------------------------------------------------------------------
BYTES_TABLE = [
    ((64, 64), ("x", "y"), 1), ((64, 64), (None, "y"), 2),
    ((64, 64), ("x", None), 3), ((32, 16, 16), ("x", None, "z"), 2),
    ((32, 16, 16), (None, None, "z"), 4), ((4096, 4096), ("x", "y"), 1),
    ((128, 512, 512), ("x", None, None), 1), ((640, 640), ("data", "model"), 3),
    ((1 << 20,), ("x",), 2),
]


@pytest.mark.parametrize("local,dims,r", BYTES_TABLE)
@pytest.mark.parametrize("mode", ["stepwise", "fused", "overlap"])
@pytest.mark.parametrize("t", [1, 4])
def test_halo_bytes_match_jax(local, dims, r, mode, t):
    pytest.importorskip("jax")
    from repro.stencil.distributed import halo_bytes_per_step as jbytes
    for nbytes in (2, 4):
        assert tdist.halo_bytes_per_step(local, dims, r, t, mode, nbytes) \
            == jbytes(local, dims, r, t, mode, nbytes)


def _simulated(local_shape, dim_axis_names, h, dtype_bytes):
    """``_extend``'s exchange order: when dim d is exchanged, every earlier
    dim is already extended by 2h (JAX's test_distributed.py)."""
    shape = list(local_shape)
    total = 0
    for dim, ax in enumerate(dim_axis_names):
        if ax is not None:
            face = 1
            for d2, n in enumerate(shape):
                if d2 != dim:
                    face *= n
            total += 2 * h * face * dtype_bytes
        shape[dim] += 2 * h
    return total


@pytest.mark.parametrize("local,dims,h", BYTES_TABLE[:5])
def test_halo_bytes_match_the_exchange_simulation(local, dims, h):
    assert tdist.halo_bytes_per_step(local, dims, h, 1, "stepwise", 4) == \
        _simulated(local, dims, h, 4)


def test_halo_benchmark_matches_jax():
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(SRC, ".."))
    try:
        from benchmarks import halo as jhalo
    finally:
        sys.path.pop(0)
    from repro_torch.benchmarks import halo as thalo
    assert thalo.run() == jhalo.run()


# ---------------------------------------------------------------------------
# Host-side pieces without a world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["zero", "replicate", "reflect"])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("lo", [True, False])
def test_dim_fill_matches_jax(mode, dim, lo):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.stencil.distributed import _dim_fill as jfill
    x = np.random.default_rng(1).normal(size=(9, 11)).astype(np.float32)
    got = tdist._dim_fill(torch.from_numpy(x), dim, 3, mode, lo).numpy()
    assert np.array_equal(got, np.asarray(jfill(jnp.asarray(x), dim, 3, mode,
                                                lo)))


@pytest.mark.parametrize("kind,d,r", [("box", 2, 1), ("star", 2, 3),
                                      ("box", 3, 1), ("star", 1, 2)])
def test_apply_stencil_valid_matches_jax(kind, d, r):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.stencil.distributed import apply_stencil_valid as jvalid
    w = make_weights(StencilSpec(kind, d, r), seed=4)
    x = np.random.default_rng(4).normal(size=(12,) * d).astype(np.float32)
    got = tdist.apply_stencil_valid(torch.from_numpy(x), w,
                                    support=w != 0).numpy()
    want = np.asarray(jvalid(jnp.asarray(x), jnp.asarray(w), support=w != 0))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(x).max()))
