"""The whole slice against the JAX package: ``stencil_plan(...)(x)`` of the
port on the CPU against the JAX plan, for the tap-sum regimes and the
reference backend (the banded regimes are in test_torch_plan_matmul.py),
plus decisions, the plan cache, ``explain`` and ``run``."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import perfmodel as jpm  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.stencil import StencilSpec  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

#: The port's H100 data-sheet spec as a JAX HardwareSpec, so the JAX
#: decision procedure can be asked the same question.
J_H100 = jpm.HardwareSpec(**{f: getattr(tpm.H100_SXM_DATASHEET, f) for f in
                             ("name", "p_vector", "p_matrix", "bandwidth",
                              "p_sparse")})


def run_both(backend, kind, r, t, shape=(32, 64), dtype=torch.float32,
             seed=0):
    w = make_weights(JSpec(kind, 2, r), seed=seed + r)
    x = np.random.default_rng(seed + t).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    plan = tk.stencil_plan(w, shape, dtype, t, backend=backend, device="cpu")
    port = plan(xt)
    assert port.dtype == dtype and tuple(port.shape) == shape
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jplan.stencil_plan(w, shape, jdt, t, backend=backend)
    ref = np.asarray(jp(jnp.asarray(x).astype(jdt))).astype(np.float32)
    return x, plan, port.float().numpy(), ref


def tolerance(x, dtype, t, launches):
    """f32: XLA and torch form FMAs differently, 1e-5 * max|x| per step.
    bf16: an f32 difference can flip a bf16 rounding; two bf16 ulps of
    max|x| per rounding (one per launch, plus one per in-launch step of
    the banded regimes, whose operands round every step)."""
    mx = float(np.abs(x).max())
    if dtype == torch.bfloat16:
        return 2 * 2.0**-8 * mx * launches
    return 1e-5 * mx * t


def check_decision(plan, t, dtype_bytes):
    g = plan.geom
    assert (g.h_block, g.w_block) == (t * plan.spec.radius,) * 2
    jd = jplan.decide(JSpec(plan.spec.shape, 2, plan.spec.radius), t,
                      dtype_bytes, hw=J_H100, tile_n=16, strip_m=g.strip_m,
                      h_block=g.h_block, w_tile=g.w_tile, w_block=g.w_block)
    d = plan.decision
    assert (d.backend, d.scenario.name, d.reason) == \
        (jd.backend, jd.scenario.name, jd.reason)
    assert d.candidates.keys() == jd.candidates.keys()
    for k in d.candidates:
        assert d.candidates[k] == pytest.approx(jd.candidates[k], rel=1e-12)


@pytest.mark.parametrize("backend", ["direct", "fused_direct", "reference"])
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_plan_matches_jax(backend, kind, r, t):
    x, plan, port, ref = run_both(backend, kind, r, t)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.float32, t, 1))
    check_decision(plan, t, 4)


@pytest.mark.parametrize("backend", ["direct", "fused_direct", "matmul",
                                     "fused_matmul", "fused_matmul_reuse",
                                     "reference"])
def test_plan_matches_jax_bf16(backend):
    t = 2
    x, plan, port, ref = run_both(backend, "box", 1, t, shape=(40, 67),
                                  dtype=torch.bfloat16)
    launches = {"direct": t, "matmul": 2 * t, "fused_matmul_reuse": t + 1,
                "reference": 2 * t}.get(backend, 1)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tolerance(x, torch.bfloat16, t, launches))
    check_decision(plan, t, 2)


def test_auto_plan_executes_its_decision():
    w = make_weights(JSpec("star", 2, 1), seed=0)
    plan = tk.stencil_plan(w, (32, 64), torch.float32, 4, device="cpu")
    assert plan.backend == plan.decision.backend
    assert "read_amp" in plan.decision.reason
    assert "(override" not in plan.explain()
    over = tk.stencil_plan(w, (32, 64), torch.float32, 4, device="cpu",
                           backend="reference")
    assert "override; auto would pick" in over.explain()


def _cache_view():
    """The plan cache's own counters (the guard layer's counters are held
    in test_torch_guard.py)."""
    s = tk.plan_cache_stats()
    return {k: s[k] for k in ("hits", "misses", "size")}


def test_plan_cache_hits_and_misses():
    tk.clear_plan_cache()
    w = make_weights(JSpec("box", 2, 1), seed=0)
    base = dict(device="cpu", backend="fused_direct")
    p1 = tk.stencil_plan(w, (32, 32), torch.float32, 2, **base)
    assert _cache_view() == {"hits": 0, "misses": 1, "size": 1}
    assert tk.stencil_plan(w, (32, 32), np.float32, 2, **base) is p1
    distinct = [
        tk.stencil_plan(w, (32, 32), torch.bfloat16, 2, **base),   # dtype
        tk.stencil_plan(w, (32, 32), torch.float32, 3, **base),    # t
        tk.stencil_plan(w, (32, 32), torch.float32, 2, device="cpu",
                        backend="matmul"),                         # backend
        tk.stencil_plan(w, (32, 32), torch.float32, 2, tile_m=16,
                        **base),                                    # tiling
        tk.stencil_plan(w, (32, 32), torch.float32, 2, hw=tpm.A100_FLOAT,
                        **base),                                    # hw
        tk.stencil_plan(w * 2, (32, 32), torch.float32, 2, **base),  # weights
        tk.stencil_plan(w, (48, 32), torch.float32, 2, **base),    # grid
    ]
    assert len({id(p) for p in distinct + [p1]}) == len(distinct) + 1
    stats = tk.plan_cache_stats()
    assert (stats["hits"], stats["misses"]) == (1, 1 + len(distinct))
    uncached = tk.stencil_plan(w, (32, 32), torch.float32, 2,
                               use_cache=False, **base)
    assert uncached is not p1 and tk.plan_cache_stats()["size"] == 8
    tk.clear_plan_cache()
    assert _cache_view() == {"hits": 0, "misses": 0, "size": 0}
    # the guard layer's counters stay zero on runs where nothing failed,
    # and the auditor's on runs that audit nothing
    assert {k: v for k, v in tk.plan_cache_stats().items()
            if k not in ("hits", "misses", "size")} == {
        "build_failures": 0, "exec_failures": 0, "fallbacks": 0,
        "negative_hits": 0, "negative_size": 0, "audits_run": 0,
        "audit_violations": 0}


def test_plan_cache_is_bounded(monkeypatch):
    tk.clear_plan_cache()
    monkeypatch.setenv("REPRO_PLAN_CACHE_SIZE", "2")
    w = make_weights(JSpec("box", 2, 1), seed=0)
    for t in (1, 2, 3):
        tk.stencil_plan(w, (32, 32), torch.float32, t, device="cpu",
                        backend="direct")
    assert tk.plan_cache_stats()["size"] == 2
    tk.clear_plan_cache()


@pytest.mark.parametrize("shape", [(32, 64), (40, 67), (1024, 1030)])
@pytest.mark.parametrize("t", [1, 4])
def test_explain_equals_plan_decision(shape, t):
    w = make_weights(JSpec("box", 2, 2), seed=0)
    plan = tk.stencil_plan(w, shape, torch.float32, t, device="cpu",
                           use_cache=False)
    assert tk.explain(w, t, 4, grid_shape=shape) == plan.decision
    assert tk.explain(w, t, 4, grid_shape=shape, tile_m=16) == \
        tk.stencil_plan(w, shape, torch.float32, t, device="cpu",
                        tile_m=16, use_cache=False).decision


def test_run_and_step():
    w = make_weights(JSpec("star", 2, 1), seed=0)
    x = torch.randn(32, 48, generator=torch.Generator().manual_seed(0))
    plan = tk.stencil_plan(w, x.shape, torch.float32, 2, device="cpu",
                           backend="fused_direct")
    y = x
    for _ in range(3):
        y = plan(y)
    assert torch.equal(plan.run(x, 3), y)
    assert torch.equal(plan.step(x), plan(x))
    assert torch.equal(plan.run(x, 0), x)
    with pytest.raises(ValueError):
        plan.run(x, -1)
    with pytest.raises(ValueError, match="built for grid"):
        plan(torch.zeros(16, 48))
    with pytest.raises(ValueError, match="built for"):
        plan(x.double())


def test_spec_and_weights_inputs():
    spec = StencilSpec("star", 2, 2)
    plan = tk.stencil_plan(spec, (32, 32), torch.float32, 1, device="cpu")
    assert plan.spec == spec
    w = make_weights(JSpec("box", 2, 3), seed=0)
    assert tplan.spec_from_weights(w) == StencilSpec("box", 2, 3)
    with pytest.raises(ValueError, match="fusion depth"):
        tk.stencil_plan(w, (32, 32), torch.float32, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tk.stencil_plan(w, (32, 32), torch.float32, 1, device="cpu",
                        backend="nope")
    with pytest.raises(ValueError, match="kernel rank"):
        tk.stencil_plan(w, (32,), torch.float32, 1, device="cpu")


def test_stencil_apply_matches_plan():
    w = make_weights(JSpec("box", 2, 1), seed=0)
    x = torch.randn(32, 48, generator=torch.Generator().manual_seed(1))
    for backend in ("auto", "matmul"):
        y = tk.stencil_apply(x, w, 2, backend=backend)
        plan = tk.stencil_plan(w, x.shape, x.dtype, 2, device="cpu",
                               backend=None if backend == "auto" else backend)
        assert torch.equal(y, plan(x))
    assert set(tk.BACKENDS) == {"direct", "fused_direct", "matmul",
                                "fused_matmul", "fused_matmul_reuse",
                                "sparse_matmul", "fused_sparse_matmul",
                                "reference", "legacy_direct",
                                "legacy_matmul", "direct_wholestrip",
                                "fused_direct_wholestrip",
                                "matmul_wholestrip",
                                "fused_matmul_wholestrip",
                                "fused_matmul_reuse_wholestrip", "auto"}
    assert tk.fallback_ladder() == ("fused_matmul_reuse",
                                    "fused_sparse_matmul", "sparse_matmul",
                                    "fused_matmul", "matmul", "fused_direct",
                                    "direct", "fused_direct_wholestrip",
                                    "direct_wholestrip", "reference")


@pytest.mark.parametrize("backend", ["fused_direct", "fused_matmul_reuse"])
@pytest.mark.parametrize("width", [37, 257])
def test_column_tiled_plan_matches_jax(backend, width):
    # K4: the port's 2D tile carries the x-halo and masks ragged widths;
    # held against the JAX plan on its column-tiled substrate (w_tile=32,
    # interpret mode), which extends the columns on the host instead
    shape, t = (32, width), 2
    w = make_weights(JSpec("box", 2, 1), seed=1)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    plan = tk.stencil_plan(w, shape, torch.float32, t, backend=backend,
                           w_tile=32, device="cpu")
    assert plan.geom.w_tile == 32 and -(-width // 32) > 1
    port = plan(torch.from_numpy(x)).numpy()
    jp = jplan.stencil_plan(w, shape, jnp.float32, t, backend=backend,
                            w_tile=32)
    assert "w_tile=32" in jp.decision.reason
    np.testing.assert_allclose(port, np.asarray(jp(jnp.asarray(x))), rtol=0,
                               atol=tolerance(x, torch.float32, t, 1))
