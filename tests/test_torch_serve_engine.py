"""The port's StencilServer on the CPU (``device="cpu"``): futures,
batching, metrics and fault paths, mirrored from
``tests/test_serve_engine.py``; the concurrency satellites the engine
leans on (plan-LRU thread safety, event-log stress, latency histogram);
and one round trip that submits the same requests to the port's engine
and to the JAX one (interpret mode) and compares every response."""
import math
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve import StencilServer as JStencilServer  # noqa: E402
from repro.stencil import StencilSpec as JSpec  # noqa: E402
from repro.stencil import jacobi_weights as jjacobi  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro.core import events as jevents  # noqa: E402
from repro.kernels import clear_plan_cache as jclear  # noqa: E402
from repro_torch.core import events  # noqa: E402
from repro_torch.core.events import EventLog  # noqa: E402
from repro_torch.kernels import (clear_plan_cache, plan_cache_stats,  # noqa: E402
                                 stencil_plan)
from repro_torch.kernels.ref import stencil_direct_ref  # noqa: E402
from repro_torch.serve import (LatencyHistogram, ServeMetrics,  # noqa: E402
                               StencilServer)
from repro_torch.stencil import StencilSpec, jacobi_weights  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

GRID = (8, 8)
W_BOX = jacobi_weights(StencilSpec("box", 2, 1))
W_STAR = jacobi_weights(StencilSpec("star", 2, 1))
RNG = np.random.default_rng(3)
XS = [torch.from_numpy(RNG.normal(size=GRID).astype(np.float32))
      for _ in range(6)]


def _server(**kw):
    return StencilServer(device="cpu", **kw)


def _ref(w, x, t=1):
    return stencil_direct_ref(x, w, t)


def _unbatched(w, x, t=1, **kw):
    """The serving contract's oracle: the UNBATCHED plan of the same
    signature (auto backend selection included)."""
    return stencil_plan(w, tuple(x.shape), x.dtype, t, device="cpu", **kw)(x)


class TestEngineRoundTrip:
    def test_futures_resolve_bitwise_across_signatures(self):
        with _server(max_batch=8, queue_timeout_ms=20) as server:
            futs = [(w, x, server.submit(w, x, t=2))
                    for x in XS for w in (W_BOX, W_STAR)]
            for w, x, fut in futs:
                got = fut.result(timeout=60)
                # responses are host tensors sliced from one copy
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
                assert torch.equal(got, _unbatched(w, x, t=2))
            snap = server.stats()
        assert snap["submitted"] == snap["responded"] == len(futs)
        assert snap["failed"] == 0
        assert snap["distinct_signatures"] == 2
        assert snap["batches"] >= 2
        assert 0.0 < snap["batch_occupancy"] <= 1.0
        assert snap["latency"]["count"] == len(futs)
        assert snap["latency"]["p99_ms"] >= snap["latency"]["p50_ms"] > 0

    def test_bf16_requests(self):
        xs = [x.to(torch.bfloat16) for x in XS[:3]]
        with _server(max_batch=4, queue_timeout_ms=20) as server:
            futs = [server.submit(W_BOX, x) for x in xs]
            for x, fut in zip(xs, futs):
                got = fut.result(timeout=60)
                assert got.dtype == torch.bfloat16
                assert torch.equal(got, _unbatched(W_BOX, x))

    def test_plan_sharing_across_batches(self):
        clear_plan_cache()
        with _server(max_batch=4, buckets=(4,),
                     queue_timeout_ms=20) as server:
            for _ in range(3):
                futs = [server.submit(W_BOX, x) for x in XS[:4]]
                for fut in futs:
                    fut.result(timeout=60)
            snap = server.stats()
        assert snap["engine_plans"] == 1
        st = plan_cache_stats()
        assert st["misses"] >= 1 and st["build_failures"] == 0

    def test_shutdown_drains_never_drops(self):
        server = _server(max_batch=64, queue_timeout_ms=500)
        futs = [server.submit(W_BOX, x) for x in XS]
        server.shutdown()
        for x, fut in zip(XS, futs):
            assert torch.equal(fut.result(timeout=10), _unbatched(W_BOX, x))
        with pytest.raises(RuntimeError, match="shut down"):
            server.submit(W_BOX, XS[0])

    def test_numpy_requests_are_accepted(self):
        with _server(max_batch=2, queue_timeout_ms=0) as server:
            got = server.submit(W_BOX, XS[0].numpy()).result(timeout=60)
        assert torch.equal(got, _unbatched(W_BOX, XS[0]))


class TestEngineErrorPaths:
    def test_submit_validates_in_caller_thread(self):
        with _server(queue_timeout_ms=0) as server:
            with pytest.raises(ValueError, match="fusion depth"):
                server.submit(W_BOX, XS[0], t=0)
            with pytest.raises(ValueError, match="rank"):
                server.submit(W_BOX, torch.zeros(4, 4, 4))
            for bad in ("batch", "batch_mode", "mesh", "shard_spec"):
                with pytest.raises(ValueError, match=bad):
                    server.submit(W_BOX, XS[0], **{bad: 2})
            snap = server.stats()
        assert snap["submitted"] == snap["failed"] == 0

    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="max_batch"):
            _server(max_batch=0)
        with pytest.raises(ValueError, match="buckets"):
            _server(buckets=(0, 2))
        with pytest.raises(ValueError, match="queue_timeout_ms"):
            _server(queue_timeout_ms=-1)

    def test_the_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StencilServer()

    def test_env_knobs_reach_constructor(self, monkeypatch):
        monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "5")
        monkeypatch.setenv("REPRO_SERVE_BUCKETS", "4,1")
        with _server(queue_timeout_ms=0) as server:
            assert server.max_batch == 5
            assert server.buckets == (1, 4)
        monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "zero")
        with pytest.raises(ValueError, match="REPRO_SERVE_MAX_BATCH"):
            _server(queue_timeout_ms=0)

    def test_unguarded_kernel_failure_fails_the_futures(self):
        events.clear()
        clear_plan_cache()
        with faults.inject("compile", times=math.inf):
            with _server(guard=False, queue_timeout_ms=20,
                         max_batch=4) as server:
                futs = [server.submit(W_BOX, x, backend="fused_direct")
                        for x in XS[:3]]
                for fut in futs:
                    with pytest.raises(RuntimeError, match="injected"):
                        fut.result(timeout=60)
                snap = server.stats()
        assert snap["failed"] == 3
        assert snap["responded"] == 0
        assert snap["submitted"] == 3
        events.clear()
        clear_plan_cache()

    def test_vmem_fault_degrades_batch_but_answers_everyone(self):
        """The JAX acceptance test: a vmem fault during the batched build
        walks the ladder (same backend, degraded tile), the batch runs
        degraded, and every request still gets the oracle's answer; the
        same spec lands the JAX engine on the same rung with the same
        events."""
        events.clear()
        clear_plan_cache()
        with faults.inject("vmem", times=1):
            with _server(guard=True, queue_timeout_ms=100, max_batch=6,
                         buckets=(8,)) as server:
                futs = [server.submit(W_BOX, x, backend="fused_direct")
                        for x in XS]
                results = [fut.result(timeout=120) for fut in futs]
                rung = next(iter(server._plans.values())).rung
        for x, got in zip(XS, results):
            assert torch.equal(got, _ref(W_BOX, x))
        snap = server.stats()
        assert snap["degraded_batches"] >= 1
        assert snap["failed"] == 0 and snap["responded"] == len(XS)
        kinds = [e["kind"] for e in events.events()]

        jevents.clear()
        jclear()
        with jfaults.inject("vmem", times=1):
            with JStencilServer(guard=True, queue_timeout_ms=100,
                                max_batch=6, buckets=(8,),
                                interpret=True) as jserver:
                jfuts = [jserver.submit(jjacobi(JSpec("box", 2, 1)),
                                        x.numpy(), backend="fused_direct")
                         for x in XS]
                for f in jfuts:
                    f.result(timeout=120)
                jrung = next(iter(jserver._plans.values())).rung
        jkinds = [e["kind"] for e in jevents.events()]
        assert rung == jrung == "fused_direct+degraded"
        assert kinds == jkinds == ["guard_failure", "guard_fallback"]
        events.clear()
        jevents.clear()
        clear_plan_cache()
        jclear()


def test_round_trip_matches_the_jax_engine():
    """The same requests through both engines (JAX in interpret mode):
    every response within the tolerance of tests/test_torch_plan.py
    (f32: 1e-5 * max|x| per step)."""
    t = 2
    reqs = [(w, x) for x in XS for w in (W_BOX, W_STAR)]
    with _server(max_batch=8, queue_timeout_ms=20) as server:
        ours = [server.submit(w, x, t=t) for w, x in reqs]
        ours = [f.result(timeout=60) for f in ours]
    with JStencilServer(max_batch=8, queue_timeout_ms=20,
                        interpret=True) as jserver:
        theirs = [jserver.submit(w, jnp.asarray(x.numpy()), t=t)
                  for w, x in reqs]
        theirs = [f.result(timeout=120) for f in theirs]
    for (w, x), got, want in zip(reqs, ours, theirs):
        tol = 1e-5 * float(x.abs().max()) * t
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)


class TestPlanCacheThreadSafety:
    def test_concurrent_lookups_keep_counters_consistent(self):
        """N threads hammer stencil_plan over a handful of signatures;
        afterwards hits + misses == lookups exactly and the LRU holds
        exactly the distinct signatures."""
        clear_plan_cache()
        sigs = [(W_BOX, 1), (W_BOX, 2), (W_STAR, 1), (W_STAR, 2)]
        n_threads, per_thread = 8, 40
        errors = []

        def worker(tid):
            try:
                for i in range(per_thread):
                    w, t = sigs[(tid + i) % len(sigs)]
                    p = stencil_plan(w, GRID, torch.float32, t,
                                     backend="reference", device="cpu")
                    assert p.input_shape == GRID
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not errors
        st = plan_cache_stats()
        assert st["hits"] + st["misses"] == n_threads * per_thread
        assert st["misses"] >= len(sigs)
        assert st["size"] == len(sigs)
        clear_plan_cache()


class TestEventLogStress:
    def test_threaded_no_lost_updates(self):
        log = EventLog(capacity=64)
        n_threads, per_thread = 8, 500

        def writer(tid):
            for i in range(per_thread):
                log.record("stress", tid=tid, i=i)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        snap = log.snapshot()
        total = n_threads * per_thread
        assert snap["recorded"] == total
        assert snap["dropped"] == total - 64
        assert len(snap["events"]) == len(log) == 64
        seqs = [e["seq"] for e in snap["events"]]
        assert len(set(seqs)) == 64
        assert max(seqs) == total - 1


class TestLatencyMetrics:
    def test_histogram_percentiles_bounded_by_observations(self):
        h = LatencyHistogram()
        for s in [i * 1e-4 for i in range(1, 101)]:
            h.record(s)
        snap = h.snapshot()
        assert snap["count"] == 100
        assert snap["min_ms"] <= snap["p50_ms"] <= snap["p99_ms"] \
            <= snap["max_ms"]
        assert snap["p50_ms"] == pytest.approx(5.0, rel=1.0)
        assert snap["mean_ms"] == pytest.approx(5.05, rel=1e-6)

    def test_histogram_rejects_negative_and_empty_is_zero(self):
        h = LatencyHistogram()
        with pytest.raises(ValueError, match=">= 0"):
            h.record(-1e-6)
        assert h.snapshot()["p99_ms"] == 0.0
        with pytest.raises(ValueError, match="quantile"):
            h.percentile(1.5)

    def test_serve_metrics_batch_accounting(self):
        m = ServeMetrics()
        m.record_submits(("sig",), 3, first_submit_s=100.0)
        m.record_batch(3, 4)
        m.record_responses([0.001, 0.002, 0.003])
        snap = m.snapshot()
        assert snap["submitted"] == snap["responded"] == 3
        assert snap["batches"] == 1 and snap["padded_slots"] == 1
        assert snap["batch_occupancy"] == 0.75
        assert snap["latency"]["count"] == 3
        m.reset()
        assert m.snapshot()["submitted"] == 0
