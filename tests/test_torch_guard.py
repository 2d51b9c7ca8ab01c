"""The guarded execution layer against the JAX package: under the same
``REPRO_FAULTS`` specs the port's guarded plan (``device="cpu"``) lands on
the same rung as the JAX guarded plan (interpret mode), records the same
events and keeps the same negative-registry counts; ``classify_failure``
maps the port's own error texts and the JAX spellings to the same
classes; a clean run is invisible; the degraded rung shrinks the tile."""
import math
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import events as jevents  # noqa: E402
from repro.kernels import guard as jguard  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.core import events as tevents  # noqa: E402
from repro_torch.kernels import _build, common, guard as tguard  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

W = make_weights(JSpec("box", 2, 1), seed=0)
X = np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32)
#: Counters both packages keep.
STATS = ("hits", "misses", "size", "build_failures", "exec_failures",
         "fallbacks", "negative_hits", "negative_size", "audits_run",
         "audit_violations")


@pytest.fixture(autouse=True)
def _hygiene():
    """Every test starts and ends with no armed faults, empty event logs
    and cold plan caches in both packages (guard state is global)."""
    def reset():
        for f, e, p in ((jfaults, jevents, jplan), (tfaults, tevents, tplan)):
            f.reset_faults()
            e.clear()
            p.clear_plan_cache()
    reset()
    yield
    reset()


def _ref(t):
    return tk.stencil_plan(W, X.shape, torch.float32, t, backend="reference",
                           device="cpu", use_cache=False)(
        torch.from_numpy(X)).numpy()


def _guarded(pkg, t, **kw):
    if pkg == "jax":
        g = jguard.guarded_stencil_plan(W, X.shape, np.float32, t, **kw)
        return g, np.asarray(g(jnp.asarray(X)))
    g = tguard.guarded_stencil_plan(W, X.shape, torch.float32, t,
                                    device="cpu", **kw)
    return g, g(torch.from_numpy(X)).numpy()


def _record(pkg, calls):
    """Run ``calls`` -- (t, guarded-plan kwargs) in order -- in one package
    and return what the guard did: per call the rung, the executing
    backend and the failure causes, then the event kinds and the
    counters."""
    events, faults, plan = ((jevents, jfaults, jplan) if pkg == "jax"
                            else (tevents, tfaults, tplan))
    faults.reset_faults()
    out, ys = [], []
    for t, kw in calls:
        g, y = _guarded(pkg, t, **kw)
        ys.append((t, y))
        out.append((g.rung, g.backend, [h["cause"] for h in g.history]))
    stats = plan.plan_cache_stats()
    for t, y in ys:       # f32, 1e-5 * max|x| per step (test_torch_plan)
        np.testing.assert_allclose(y, _ref(t), rtol=0,
                                   atol=1e-5 * t * float(np.abs(X).max()))
    return (out, [e["kind"] for e in events.events()],
            {k: stats[k] for k in STATS})


@pytest.mark.parametrize("spec,calls,lands", [
    ("compile", [(2, dict(backend="fused_direct"))],
     "fused_direct+degraded"),
    # three kernel rungs fail: the ladder lands on the whole-strip foil
    ("compile:3", [(2, dict(backend="fused_direct"))],
     "fused_direct_wholestrip"),
    # the third launch of direct's first call overflows
    ("vmem:1@2", [(3, dict(backend="direct"))], "direct+degraded"),
    ("compile:inf", [(2, dict(backend="fused_matmul_reuse"))], "reference"),
    ("nan", [(2, dict(backend="fused_direct", watchdog=True))],
     "fused_direct+degraded"),
    # a known-bad signature is skipped by the next guarded plan
    ("compile", [(2, dict(backend="fused_direct")),
                 (2, dict(backend="fused_direct"))],
     "fused_direct+degraded"),
])
def test_same_spec_lands_on_the_same_rung(monkeypatch, spec, calls, lands):
    monkeypatch.setenv("REPRO_FAULTS", spec)
    theirs = _record("jax", calls)
    for f, e, p in ((jfaults, jevents, jplan), (tfaults, tevents, tplan)):
        f.reset_faults()
        e.clear()
        p.clear_plan_cache()
    ours = _record("torch", calls)
    assert ours == theirs
    assert ours[0][-1][0] == lands
    if spec == "compile:inf":
        assert ours[0][0][1] == "reference"
        assert set(ours[0][0][2]) == {"compile"}


@pytest.mark.parametrize("requested,start", [
    (None, "fused_matmul_reuse"), ("fused_direct", "fused_direct"),
    ("legacy_direct", "legacy_direct")])
def test_card_ladder_ends_at_the_last_kernel_rung(requested, start):
    cpu = [r.label() for r in tguard._ladder(requested, start, False)]
    card = [r.label() for r in tguard._ladder(requested, start, True)]
    assert cpu[-1] == "reference"
    assert card == [r for r in cpu if r != "reference"]
    assert card[-1] == "direct_wholestrip"
    # a caller who asks for the plain version on the card gets it, alone
    assert [r.label() for r in tguard._ladder("reference", "reference",
                                              True)] == \
        ["reference", "reference+degraded"]


def _as_on_card(monkeypatch):
    """Make the guard treat a CPU plan as a plan on the card (ladder and
    watchdog); the rungs still run their plain versions here."""
    monkeypatch.setattr(tguard, "_on_card", lambda device: True)


def test_exhausted_card_ladder_raises_with_history(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "compile:inf")
    _as_on_card(monkeypatch)
    with pytest.raises(tguard.GuardedExecutionError,
                       match="ladder exhausted") as e:
        _guarded("torch", 2, backend="fused_matmul_reuse")
    rungs = [h["rung"] for h in e.value.history]
    assert rungs[0] == "fused_matmul_reuse"
    assert rungs[-1] == "direct_wholestrip"
    assert "reference" not in rungs
    assert {h["cause"] for h in e.value.history} == {"compile"}
    assert "direct_wholestrip (compile)" in str(e.value)


def test_card_watchdog_reruns_on_the_next_kernel_rung(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "nan")
    _as_on_card(monkeypatch)
    g, y = _guarded("torch", 2, backend="fused_direct", watchdog=True)
    assert g.rung == "fused_direct+degraded"
    assert g._checked is None            # no plain re-run was built
    assert [(e["kind"], e.get("action")) for e in tevents.events()
            if e["kind"] == "guard_watchdog"] == \
        [("guard_watchdog", "next_rung")]
    np.testing.assert_allclose(y, _ref(2), rtol=0,
                               atol=1e-5 * 2 * float(np.abs(X).max()))


def test_card_watchdog_raises_when_no_kernel_rung_is_left(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "nan:inf")
    _as_on_card(monkeypatch)
    with pytest.raises(tguard.NumericalFaultError, match="NaN/Inf"):
        _guarded("torch", 2, backend="direct_wholestrip", watchdog=True)


def test_clean_run_is_invisible():
    p0 = tk.stencil_plan(W, X.shape, torch.float32, 2, backend="fused_direct",
                         device="cpu")
    g = tk.guarded_stencil_plan(W, X.shape, torch.float32, 2,
                                backend="fused_direct", device="cpu")
    assert g.plan is p0                  # the identical cached plan object
    y = g(torch.from_numpy(X))
    assert not g.degraded and g.history == []
    assert tevents.events() == []
    st = tk.plan_cache_stats()
    assert st["build_failures"] == st["exec_failures"] == st["fallbacks"] \
        == st["negative_hits"] == st["negative_size"] == 0
    assert torch.equal(y, p0(torch.from_numpy(X)))
    assert "clean" in g.explain()
    # and stencil_apply(guard=True) runs the same plan
    assert torch.equal(tk.stencil_apply(torch.from_numpy(X), W, 2,
                                        backend="fused_direct", guard=True), y)


def test_user_errors_raise_raw_not_laddered(monkeypatch):
    with pytest.raises(ValueError, match="fusion depth"):
        tk.guarded_stencil_plan(W, X.shape, torch.float32, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tk.guarded_stencil_plan(W, X.shape, torch.float32, 2, backend="nope",
                                device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tk.guarded_stencil_plan(W, (8, 8, 8), torch.float32, 2,
                                device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.guarded_stencil_plan(W, X.shape, torch.float32, 2)
    assert tevents.events() == []


# ---------------------------------------------------------------------------
# The taxonomy: the port's real error texts and the JAX spellings
# ---------------------------------------------------------------------------
def _nvcc_failure(tmp_path) -> RuntimeError:
    """The error ``_build`` raises when nvcc fails, from the code itself."""
    out = tmp_path / "stencil_direct-0.so"
    out.with_suffix(f".{os.getpid()}.log").write_text(
        "ptxas error   : Entry function uses too much data")
    proc = types.SimpleNamespace(wait=lambda: 1, returncode=1)
    with pytest.raises(RuntimeError) as e:
        _build._finish("stencil_direct", out, proc)
    return e.value


def _launch_failure(monkeypatch, code: int, text: str) -> RuntimeError:
    """The error a wrapper raises when its launch returns ``code``: the
    text of ``_build.check``, with CUDA's own string for the code."""
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        error_string=lambda err: text.encode()))
    with pytest.raises(RuntimeError) as e:
        _build.check(code, "stencil_banded")
    return e.value


@pytest.mark.parametrize("code,text,cls", [
    (701, "too many resources requested for launch",
     tguard.VmemOverflowError),
    (1, "invalid argument", tguard.KernelCompileError),
    (209, "no kernel image is available for execution on the device",
     tguard.KernelCompileError),
    (2, "out of memory", tguard.VmemOverflowError),
    (700, "an illegal memory access was encountered",
     tguard.DeviceFaultError),
    (719, "unspecified launch failure", tguard.DeviceFaultError),
    (716, "misaligned address", tguard.DeviceFaultError),
])
def test_launch_errors_classify(monkeypatch, code, text, cls):
    # prepare_launch's attribute calls and the launch itself return their
    # cudaError_t through the C entry point; _build.check raises its text
    err = _launch_failure(monkeypatch, code, text)
    assert type(tguard.classify_failure(err)) is cls


def test_build_and_memory_errors_classify(tmp_path):
    assert isinstance(tguard.classify_failure(_nvcc_failure(tmp_path),
                                              stage="build"),
                      tguard.KernelCompileError)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert isinstance(tguard.classify_failure(oom), tguard.VmemOverflowError)
    # the wrappers' own shared-memory refusal (a foil's: the default
    # staging takes the workspace form past the budget) and the tile rule's
    x = torch.zeros(4096, 4096)
    geom = common.SubstrateGeom(2, strip_m=512, h_block=4, w_tile=512,
                                w_block=4)
    import importlib
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    with pytest.raises(ValueError) as e:
        sd._launch2d(x, np.asarray(W, np.float32), 4, 1, geom, (0, 0),
                     "wholestrip")
    assert isinstance(tguard.classify_failure(e.value),
                      tguard.VmemOverflowError)
    with pytest.raises(ValueError) as e:
        common.resolve_tile_geom((64, 64), 80)
    assert isinstance(tguard.classify_failure(e.value, stage="build"),
                      tguard.VmemOverflowError)


@pytest.mark.parametrize("msg", [
    "INTERNAL: Mosaic failed to compile TPU kernel",
    "RESOURCE_EXHAUSTED: Ran out of memory in memory space vmem",
    "error during ppermute collective",
    "output contained NaN after step",
    "XLA lowering failed: unsupported op",
    "something entirely unrecognized",
])
@pytest.mark.parametrize("stage", ["build", "execute"])
def test_jax_spellings_classify_alike(msg, stage):
    ours = tguard.classify_failure(RuntimeError(msg), stage=stage)
    theirs = jguard.classify_failure(RuntimeError(msg), stage=stage)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.cause == theirs.cause


@pytest.mark.parametrize("kind", ["compile", "vmem", "halo"])
def test_injected_messages_classify(kind):
    # the port's classifier takes each package's injected fault (the
    # port's mimic its own failures, the JAX package's the XLA ones) to
    # the fault's class
    for f in (jfaults, tfaults):
        with f.inject(kind), pytest.raises(RuntimeError,
                                           match="injected") as e:
            f.maybe_fail(kind)
        assert tguard.classify_failure(e.value).cause == kind


def test_sticky_errors_are_reraised_not_laddered(monkeypatch):
    g = tk.guarded_stencil_plan(W, X.shape, torch.float32, 2,
                                backend="fused_direct", device="cpu")

    def poisoned(x):
        raise RuntimeError("stencil_direct launch failed: CUDA error 700 "
                           "(an illegal memory access was encountered)")
    monkeypatch.setattr(g.plan, "fn", poisoned)
    monkeypatch.setattr(g.plan, "_reached", True)
    with pytest.raises(tguard.DeviceFaultError, match="illegal memory"):
        g(torch.from_numpy(X))
    assert not g.degraded
    assert [(e["kind"], e["cause"]) for e in tevents.events()] == \
        [("guard_failure", "device")]
    assert tk.plan_cache_stats()["fallbacks"] == 0


# ---------------------------------------------------------------------------
# The degraded rung, the fault hooks, the grammar, the event log
# ---------------------------------------------------------------------------
def test_degraded_rung_shrinks_the_tile(monkeypatch):
    # r = 3, t = 10 (h = 30): the tap-sum's buffers take 127,024 bytes on
    # a 64-row tile, under 227 KB but over half of it, so its launches take
    # 32 under half; the decision's price stays on 64 x 64, where the
    # reuse fold's layout (62,832 bytes) fits half the budget too
    from repro_torch.kernels import registry
    launched = []
    entry = registry.stencil_direct_at

    def seen(x, w, t, geom, *args):
        launched.append(geom.strip_m)
        return entry(x, w, t, geom, *args)
    monkeypatch.setattr(registry, "stencil_direct_at", seen)
    w = make_weights(JSpec("box", 2, 3), seed=0)
    x = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    normal = tk.stencil_plan(w, (128, 128), torch.float32, 10,
                             backend="fused_direct", device="cpu")
    with tfaults.inject("vmem"):
        g = tk.guarded_stencil_plan(w, (128, 128), torch.float32, 10,
                                    backend="fused_direct", device="cpu")
        y = g(x)
    assert g.rung == "fused_direct+degraded"
    assert launched == [64, 32]             # the failed launch, the rung's
    assert (normal.geom.strip_m, g.plan.geom.strip_m) == (64, 64)
    assert g.plan.key != normal.key
    assert "REPRO_VMEM_BUDGET" not in os.environ      # pin restored
    torch.testing.assert_close(y, normal(x), rtol=0, atol=0)


def test_budget_knob(monkeypatch):
    monkeypatch.delenv("REPRO_VMEM_BUDGET", raising=False)
    assert tk.smem_budget_bytes() == common.SMEM_BUDGET_BYTES
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(8 * 1024 * 1024))
    assert tk.smem_budget_bytes() == common.SMEM_BUDGET_BYTES   # ceiling
    # h = 12: the 2D tap-sum's buffers take 61,952 bytes on 64 x 64,
    # 25,136 on 32 x 32 and 12,848 on 16 x 16
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "50000")
    assert common.resolve_tile_geom((128, 128), 12).strip_m == 32
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "20000")
    assert common.resolve_tile_geom((128, 128), 12).strip_m == 16
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "garbage")
    with pytest.raises(ValueError, match="REPRO_VMEM_BUDGET must be an "
                                         "integer"):
        tk.smem_budget_bytes()


def test_hooks_fire_only_in_a_plans_first_call():
    import importlib
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    x = torch.from_numpy(X)
    plan = tk.stencil_plan(W, X.shape, torch.float32, 2,
                           backend="fused_direct", device="cpu")
    with tfaults.inject("compile", times=math.inf) as spec:
        sd.stencil_direct_at(x, W, 2, plan.geom)        # not in a plan
        assert spec.hits == 0
        with pytest.raises(RuntimeError, match="nvcc failed to build "
                                               "stencil_direct.cu"):
            plan(x)
        assert spec.fired == 1
    plan(x)                                             # reached
    with tfaults.inject("compile", times=math.inf) as spec:
        plan(x)                                         # past its first call
        assert spec.hits == 0


@pytest.mark.parametrize("raw", ["compile, vmem:3, nan:2@1, halo:inf",
                                 "geometry", "bogus", "compile:x",
                                 "compile:0", "vmem:1@-1", "nan:1.5"])
def test_fault_grammar_matches_jax(raw):
    def parse(f):
        try:
            return [(s.kind, s.times, s.skip) for s in f.parse_faults(raw)]
        except ValueError as e:
            return str(e)
    assert parse(tfaults) == parse(jfaults)
    assert tfaults.KINDS == jfaults.KINDS


def test_event_log_is_bounded():
    log = tevents.EventLog(capacity=4)
    for i in range(10):
        log.record("k", i=i)
    snap = log.snapshot()
    assert snap["recorded"] == 10 and snap["dropped"] == 6
    assert [e["i"] for e in snap["events"]] == [6, 7, 8, 9]


def test_port_imports_neither_jax_nor_repro():
    # the guard's modules come with the port; a fresh interpreter that
    # imports the whole package has loaded neither
    src = pathlib.Path(tk.__file__).resolve().parents[2]
    code = ("import sys, repro_torch, repro_torch.kernels.guard, "
            "repro_torch.testing; "
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'], "
            "sorted(m for m in sys.modules if 'jax' in m or "
            "m.startswith('repro.'))")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(src)})
