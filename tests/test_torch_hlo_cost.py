"""The aten-op cost counter (``repro_torch.core.hlo_cost``) against the JAX
package's HLO analyzer (``repro.core.hlo_cost.analyze_hlo``), on the CPU.

FLOPs: an unrolled matmul chain's dot FLOPs equal JAX's over a scan of the
same layers (JAX's counted with its own rules on its dot lines alone: its
scan also counts loop plumbing); Table 2's banded programs equal JAX's
exactly, its vector programs at t=1 too; at t>1 the fused vector programs
equal the closed form 2K * sum_{s<t} (N + 2sr)^2 / N^2 and lie within 3% of
JAX's, because eager torch counts each step's multiply and add on every
element it produces while XLA counts a fusion as one FLOP per produced
element.  The convolution rule is a standing divergence: the port counts
2 * prod(result) * prod(window) * C_in, JAX 2 per result element; the test
shows both.  Bytes, views and factories follow the stated rules, the
collectives of a 2-rank gloo world land under JAX's kind names, a send
counts its payload, and a ``ctypes`` kernel launch shows as
``opaque_launches``.  The JAX side is skipped where JAX is absent."""
import dataclasses
import importlib.util
import inspect
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.hlo_cost import COLLECTIVES, ProgramCost, analyze_program
from repro_torch.launch.world import run_world
from repro_torch.stencil import StencilSpec
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_table2():
    """The JAX package's ``benchmarks/table2.py`` (JAX side)."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_table2", ROOT / "benchmarks" / "table2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_j(spec):
    """The JAX package's spec of a port spec (JAX side)."""
    from repro.stencil import StencilSpec as JSpec
    return JSpec(spec.shape, spec.dim, spec.radius)


def _jax_flops_of_ops(fn, *avals, opcodes):
    """JAX's ``analyze_hlo`` FLOPs of ``fn`` counting only the HLO ops in
    ``opcodes`` (its own rules, trip counts and call graph)."""
    pytest.importorskip("jax")
    import jax
    from repro.core import hlo_cost as hc

    hlo = jax.jit(fn).lower(*avals).compile().as_text()
    orig = hc.analyze_computation

    def only(lines, shapes, is_entry=False, fusion_roots=None):
        full = orig(lines, shapes, is_entry=is_entry, fusion_roots=fusion_roots)
        kept = [ln for ln in lines
                if (op := hc._parse_op_line(ln)) is not None and op[2] in opcodes]
        full.flops = orig(kept, shapes, is_entry=is_entry,
                          fusion_roots=fusion_roots).flops
        return full

    hc.analyze_computation = only
    try:
        return hc.analyze_hlo(hlo).flops
    finally:
        hc.analyze_computation = orig


# ---------------------------------------------------------------------------
# FLOPs against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layers", [1, 4, 8])
def test_unrolled_chain_equals_jax_scan(layers):
    D = 64
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(D, D)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(layers, D, D)).astype(np.float32))

    def chain(h, ws):
        for i in range(layers):
            h = h @ ws[i]
        return h

    pc = analyze_program(chain, h, ws)
    assert pc.flops == 2 * layers * D ** 3        # the dots and nothing else
    assert pc.unknown_loops == 0
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    def scan(h, ws):
        return jax.lax.scan(lambda h, w: (h @ w, None), h, ws)[0]

    jdots = _jax_flops_of_ops(scan, jax.ShapeDtypeStruct((D, D), jnp.float32),
                              jax.ShapeDtypeStruct((layers, D, D), jnp.float32),
                              opcodes={"dot"})
    assert pc.flops == jdots


def test_chain_with_tanh_adds_one_flop_per_element():
    D, L = 32, 3
    h = torch.ones(D, D)
    ws = torch.ones(L, D, D) / D

    def f(h, ws):
        for i in range(L):
            h = torch.tanh(h @ ws[i])
        return h

    assert analyze_program(f, h, ws).flops == 2 * L * D ** 3 + L * D * D


@pytest.mark.parametrize("row", [4, 5], ids=["Box-2D1R-t3-f64", "Box-2D1R-t7-f32"])
def test_table2_banded_program_equals_jax(row):
    from repro_torch.benchmarks import table2

    _, spec, t, D, _ = table2.ROWS[row]
    dtype = torch.float32 if D == 4 else torch.float64
    port = table2.measured_matrix(spec, t, dtype, "cpu")
    R = spec.radius * t
    assert port == (2 * 128 * 128 * (128 + 2 * R) * (2 * R + 1)
                    + 128 * 128 * (2 * R + 1)) / (128 * 128)
    jt = _jax_table2()
    import jax.numpy as jnp
    assert port == jt._measured_matrix(spec_j(spec), t,
                                       jnp.float32 if D == 4 else jnp.float64)


def _closed_form(spec, t, n):
    return 2 * spec.num_points * sum((n + 2 * s * spec.radius) ** 2
                                     for s in range(t)) / n ** 2


@pytest.mark.parametrize("row", [0, 1, 2, 3], ids=["Box-2D1R-t3", "Box-2D3R-t1",
                                                   "Box-2D1R-t7", "Box-2D7R-t1"])
def test_table2_vector_program(row):
    """t=1: JAX's count exactly.  t>1: the closed form, within 3% of JAX's
    (XLA counts a fusion as one FLOP per produced element, eager torch the
    multiply and add of every tap)."""
    from repro_torch.benchmarks import table2

    _, spec, t, D, _ = table2.ROWS[row]
    dtype = torch.float32 if D == 4 else torch.float64
    port = table2.measured_vector(spec, t, dtype, "cpu")
    assert port == pytest.approx(_closed_form(spec, t, table2.N), rel=1e-12)
    jt = _jax_table2()
    import jax.numpy as jnp
    jax_c = jt._measured_vector(spec_j(spec), t,
                                jnp.float32 if D == 4 else jnp.float64)
    if t == 1:
        assert port == jax_c == 2 * spec.num_points
    else:
        assert port > jax_c and abs(port - jax_c) / jax_c < 0.03


def test_convolution_divergence_shows_both_counts():
    """The port counts a convolution as torch.utils.flop_counter does,
    JAX at 2 FLOPs per result element: a standing divergence."""
    x = torch.ones(1, 2, 16, 16)
    w = torch.ones(3, 2, 3, 3)
    pc = analyze_program(lambda: F.conv2d(x, w))
    result = 1 * 3 * 14 * 14
    port_rule = 2 * result * (3 * 3) * 2          # window 3x3, C_in 2
    assert pc.flops == port_rule == 21168
    assert analyze_program(lambda: F.conv2d(x, w, torch.ones(3))).flops \
        == port_rule + result                     # the bias: 1 per element
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    jconv = _jax_flops_of_ops(
        lambda x, w: jax.lax.conv(x, w, (1, 1), "VALID"),
        jax.ShapeDtypeStruct((1, 2, 16, 16), jnp.float32),
        jax.ShapeDtypeStruct((3, 2, 3, 3), jnp.float32),
        opcodes={"convolution"})
    assert jconv == 2 * result == 1176
    print(f"convolution FLOPs: port {pc.flops:.0f}, JAX {jconv:.0f}")


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------
def test_elementwise_view_and_factory_rules():
    a = torch.ones(6, 5)

    def prog(a):
        b = a + 1                                  # 30
        c = b * a                                  # 30
        d = torch.exp(c[1:, :])                    # slice: none; exp 25
        e = d.view(25).sum()                       # view none; sum 1
        z = torch.zeros(4, 4)                      # factory: none
        p = F.pad(a, (1, 1))                       # pad: none
        q = torch.cat([a, a])                      # cat: none
        r = a.to(torch.float64)                    # copy: none
        s = a.t().contiguous()                     # transpose view; clone none
        return e, z, p, q, r, s

    pc = analyze_program(prog, a)
    assert pc.flops == 30 + 30 + 25 + 1
    assert pc.coll == {} and pc.coll_counts == {} and pc.opaque_launches == 0


def test_views_cost_nothing():
    a = torch.ones(8, 8)
    pc = analyze_program(lambda: (a[2:, 1], a.view(64), a.t(), a.expand(2, 8, 8)))
    assert (pc.flops, pc.bytes, pc.bytes_major) == (0, 0, 0)


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (32, 32, 32), (5, 7, 3)])
def test_mm_and_add_bytes_closed_form(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    c = torch.ones(m, n)
    pc = analyze_program(lambda: a @ b)
    assert pc.flops == 2 * m * n * k
    assert pc.bytes == 4 * (m * n + m * k + k * n)          # result + operands
    assert pc.bytes_major == 4 * (m * k + k * n + m * n)    # read both, write one
    pa = analyze_program(lambda: c + c)
    assert pa.flops == m * n
    assert pa.bytes == 4 * m * n                            # the result alone
    assert pa.bytes_major == 4 * 3 * m * n                  # two reads, one write
    pf = analyze_program(lambda: torch.addmm(c, a, b))
    assert pf.flops == 2 * m * n * k + m * n                # the fused add
    assert pf.bytes == 4 * (m * n + m * n + m * k + k * n)


def test_batched_and_vector_dots():
    a, b = torch.ones(3, 4, 5), torch.ones(3, 5, 6)
    assert analyze_program(torch.bmm, a, b).flops == 2 * 3 * 4 * 6 * 5
    assert analyze_program(torch.matmul, a, torch.ones(5, 2)).flops == 2 * 3 * 4 * 2 * 5
    v = torch.ones(7)
    assert analyze_program(torch.dot, v, v).flops == 14
    assert analyze_program(torch.mv, torch.ones(3, 7), v).flops == 42


def test_opaque_launches_count_ctypes_kernels():
    """A wrapper counts its kernel launch in ``_build``; the counter reports
    the launches its program made, which the dispatcher cannot see."""
    from repro_torch.kernels import _build

    def prog(x):
        _build.count_launch("stencil_direct")
        _build.count_launch("stencil_banded", 2)
        return x + 1

    pc = analyze_program(prog, torch.ones(4))
    assert pc.opaque_launches == 3 and pc.flops == 4


def test_program_cost_fields_match_jax():
    pytest.importorskip("jax")
    from repro.core import hlo_cost as hc

    port = {f.name for f in dataclasses.fields(ProgramCost)}
    jax_fields = {f.name for f in dataclasses.fields(hc.ProgramCost)}
    assert port - jax_fields == {"opaque_launches", "temp_peak_bytes"}
    assert jax_fields <= port and COLLECTIVES == hc.COLLECTIVES
    assert ProgramCost(coll={"all-reduce": 8.0, "all-gather": 4.0}).collective_bytes == 12.0


# ---------------------------------------------------------------------------
# Collectives on a 2-rank gloo world
# ---------------------------------------------------------------------------
N_ELEMS = 1000


def _collective_rank(mesh, rank):
    import torch.distributed as dist
    from repro_torch.stencil import make_weights
    from repro_torch.stencil.distributed import make_distributed_stepper

    x = torch.ones(N_ELEMS)
    ar = analyze_program(dist.all_reduce, x)
    out = torch.zeros(2 * N_ELEMS)
    ag = analyze_program(dist.all_gather_into_tensor, out, x)
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    shard = torch.from_numpy(np.random.default_rng(rank).normal(size=(16, 24))
                             .astype(np.float32))
    step = make_distributed_stepper(mesh, ("world", None), w, t=2,
                                    mode="stepwise")
    step.reset_stats()
    sw = analyze_program(step, shard)
    return dict(ar=(dict(ar.coll), dict(ar.coll_counts), ar.bytes),
                ag=(dict(ag.coll), dict(ag.coll_counts)),
                step=(dict(sw.coll), dict(sw.coll_counts), dict(step.stats)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_collective_rank, 2, mesh_dim_names=("world",),
                     device="cpu", timeout_s=120,
                     workdir=str(tmp_path_factory.mktemp("hlo_cost")))


def test_all_reduce_counts_payload_once(world):
    for res in world:
        coll, counts, nbytes = res["ar"]
        assert coll == {"all-reduce": 4 * N_ELEMS}
        assert counts == {"all-reduce": 1}
        assert nbytes == 4 * N_ELEMS


def test_all_gather_counts_its_output(world):
    for res in world:
        coll, counts = res["ag"]
        assert coll == {"all-gather": 4 * 2 * N_ELEMS} and counts == {"all-gather": 1}


def test_stepwise_halo_bytes_are_collective_permute(world):
    """One stepwise call (t=2) of the distributed stepper: its sends count
    under collective-permute, their bytes equal to the halo bytes its stats
    record (factor 1: both directions' slabs, each sent once); the
    receives count nothing."""
    for res in world:
        coll, counts, stats = res["step"]
        assert set(coll) == {"collective-permute"}
        assert coll["collective-permute"] == stats["halo_bytes"] == 2 * 2 * 1 * 24 * 4
        assert counts["collective-permute"] == stats["p2p_ops"] // 2 == 4
        assert set(coll) <= set(COLLECTIVES)


def test_run_world_defaults_to_the_card():
    """``run_world`` runs its ranks' shards on the card unless asked for
    the CPU; with no card it says so before spawning anything."""
    assert inspect.signature(run_world).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_world(_collective_rank, 2)
