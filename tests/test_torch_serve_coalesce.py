"""The port's coalescer (``repro_torch.serve.coalesce``) against the JAX
one: the properties of ``tests/test_serve_coalesce.py`` as deterministic
sweeps, the same batches as the JAX ``coalesce`` on the same request
streams, ``stack_batch`` as a (pinnable) torch tensor, and the
``REPRO_SERVE_*`` knobs."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.serve import coalesce as jcoalesce  # noqa: E402
from repro.serve import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.core.envutil import env_int_list  # noqa: E402
from repro_torch.serve import (Batch, ServeRequest, choose_bucket,  # noqa: E402
                               coalesce, serve_buckets, serve_max_batch,
                               serve_queue_timeout_ms, stack_batch)
from repro_torch.serve.coalesce import (DEFAULT_BUCKETS,  # noqa: E402
                                        DEFAULT_MAX_BATCH,
                                        DEFAULT_QUEUE_TIMEOUT_MS)
from repro.serve.coalesce import choose_bucket as jchoose  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _req(sig, seq, grid=(4, 4), dtype=torch.float32, fill=None, cls=None):
    """A minimal ServeRequest: the coalescer only reads .signature (and
    stack_batch only .x), so everything else can be inert."""
    x = torch.full(grid, float(seq if fill is None else fill), dtype=dtype)
    return (cls or ServeRequest)(x=x, weights=None, grid_shape=grid,
                                 dtype=dtype, t=1, plan_kwargs={},
                                 signature=sig, future=None, submit_s=0.0,
                                 seq=seq)


def _stream(rng, n, n_sigs, cls=None):
    return [_req(("sig", int(k)), i, cls=cls)
            for i, k in enumerate(rng.integers(0, n_sigs, size=n))]


def _sweep(cls=None):
    for seed in range(20):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 120))
        n_sigs = int(rng.integers(1, 6))
        yield seed, _stream(rng, n, n_sigs, cls)


class TestChooseBucket:
    def test_pads_to_next_allowed_as_jax(self):
        for n, want in [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (9, 16),
                        (17, 32), (33, 32)]:
            assert choose_bucket(n, DEFAULT_BUCKETS, 32) == want \
                == jchoose(n, DEFAULT_BUCKETS, 32)

    def test_max_batch_filters_ladder(self):
        assert choose_bucket(7, DEFAULT_BUCKETS, 4) == 4
        assert choose_bucket(3, (1, 2, 4, 8), 8) == 4

    def test_ladder_entirely_above_cap(self):
        assert choose_bucket(3, (64, 128), 16) == 16

    def test_unsorted_duplicate_ladder(self):
        assert choose_bucket(3, (8, 2, 8, 1, 4), 32) == 4

    def test_n_below_one_raises(self):
        with pytest.raises(ValueError, match=">= 1"):
            choose_bucket(0, DEFAULT_BUCKETS, 32)


class TestCoalesceProperties:
    def test_batches_never_mix_signatures(self):
        for seed, reqs in _sweep():
            for b in coalesce(reqs, buckets=(1, 2, 4, 8), max_batch=8):
                sigs = {r.signature for r in b.requests}
                assert len(sigs) == 1 and sigs == {b.signature}, seed

    def test_every_request_lands_exactly_once(self):
        for seed, reqs in _sweep():
            out = coalesce(reqs, buckets=(1, 2, 4, 8), max_batch=8)
            seen = sorted(r.seq for b in out for r in b.requests)
            assert seen == sorted(r.seq for r in reqs), seed

    def test_arrival_order_preserved_within_signature(self):
        for seed, reqs in _sweep():
            by_sig = {}
            for b in coalesce(reqs, buckets=(1, 2, 4, 8), max_batch=8):
                by_sig.setdefault(b.signature, []).extend(
                    r.seq for r in b.requests)
            for sig, seqs in by_sig.items():
                assert seqs == sorted(seqs), (seed, sig)

    def test_bucket_bounds_and_pad_accounting(self):
        for seed, reqs in _sweep():
            for b in coalesce(reqs, buckets=(1, 2, 4, 8), max_batch=8):
                assert 1 <= len(b.requests) <= b.bucket <= 8, seed
                assert b.pad == b.bucket - len(b.requests)
                assert 0.0 < b.occupancy <= 1.0
                if b.bucket > 1:
                    assert len(b.requests) > b.bucket // 2, seed

    def test_same_batches_as_jax(self):
        for (seed, reqs), (_, jreqs) in zip(_sweep(), _sweep(JServeRequest)):
            for kw in (dict(buckets=(1, 2, 4, 8), max_batch=8),
                       dict(buckets=(4, 16), max_batch=12),
                       dict(buckets=(64,), max_batch=5)):
                got = [(b.signature, b.bucket, [r.seq for r in b.requests])
                       for b in coalesce(reqs, **kw)]
                want = [(b.signature, b.bucket,
                         [r.seq for r in b.requests])
                        for b in jcoalesce(jreqs, **kw)]
                assert got == want, (seed, kw)

    def test_cap_chunks_large_groups(self):
        reqs = [_req("s", i) for i in range(10)]
        out = coalesce(reqs, buckets=(1, 2, 4), max_batch=4)
        assert [len(b.requests) for b in out] == [4, 4, 2]
        assert [b.bucket for b in out] == [4, 4, 2]


class TestStackBatch:
    def test_slices_bitwise_and_padding_zero(self):
        reqs = [_req("s", i, fill=float(i + 1)) for i in range(3)]
        xb = stack_batch(Batch(signature="s", requests=reqs, bucket=4))
        assert isinstance(xb, torch.Tensor)
        assert tuple(xb.shape) == (4, 4, 4) and xb.dtype == torch.float32
        for i, r in enumerate(reqs):
            assert torch.equal(xb[i], r.x)
        assert torch.equal(xb[3], torch.zeros(4, 4))

    def test_dtype_follows_requests_bf16(self):
        reqs = [_req("s", 0, dtype=torch.bfloat16, fill=1.5)]
        xb = stack_batch(Batch(signature="s", requests=reqs, bucket=2))
        assert xb.dtype == torch.bfloat16
        assert torch.equal(xb[0], reqs[0].x)

    def test_unpinned_by_default(self):
        xb = stack_batch(Batch(signature="s", requests=[_req("s", 0)],
                               bucket=1))
        assert not xb.is_pinned()


class TestServeEnvKnobs:
    def test_defaults_as_jax(self, monkeypatch):
        import importlib
        jc = importlib.import_module("repro.serve.coalesce")
        for var in ("REPRO_SERVE_BUCKETS", "REPRO_SERVE_MAX_BATCH",
                    "REPRO_SERVE_QUEUE_TIMEOUT_MS"):
            monkeypatch.delenv(var, raising=False)
        assert serve_buckets() == DEFAULT_BUCKETS == jc.serve_buckets()
        assert serve_max_batch() == DEFAULT_MAX_BATCH == jc.serve_max_batch()
        assert serve_queue_timeout_ms() == DEFAULT_QUEUE_TIMEOUT_MS \
            == jc.serve_queue_timeout_ms()

    def test_overrides(self, monkeypatch):
        monkeypatch.setenv("REPRO_SERVE_BUCKETS", "8, 2,2,16")
        monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "16")
        monkeypatch.setenv("REPRO_SERVE_QUEUE_TIMEOUT_MS", "0")
        assert serve_buckets() == (2, 8, 16)
        assert serve_max_batch() == 16
        assert serve_queue_timeout_ms() == 0

    @pytest.mark.parametrize("var,raw,match", [
        ("REPRO_SERVE_BUCKETS", "1,two,4", "REPRO_SERVE_BUCKETS"),
        ("REPRO_SERVE_BUCKETS", "0,2", ">= 1"),
        ("REPRO_SERVE_MAX_BATCH", "none", "REPRO_SERVE_MAX_BATCH"),
        ("REPRO_SERVE_MAX_BATCH", "0", ">= 1"),
        ("REPRO_SERVE_QUEUE_TIMEOUT_MS", "-5", ">= 0"),
        ("REPRO_SERVE_QUEUE_TIMEOUT_MS", "fast", "integer"),
    ])
    def test_garbage_raises_naming_the_knob(self, monkeypatch, var, raw,
                                            match):
        monkeypatch.setenv(var, raw)
        fn = {"REPRO_SERVE_BUCKETS": serve_buckets,
              "REPRO_SERVE_MAX_BATCH": serve_max_batch,
              "REPRO_SERVE_QUEUE_TIMEOUT_MS": serve_queue_timeout_ms}[var]
        with pytest.raises(ValueError, match=match):
            fn()

    def test_env_int_list(self, monkeypatch):
        monkeypatch.setenv("REPRO_TEST_LIST", "1,,4, ,8,")
        assert env_int_list("REPRO_TEST_LIST", ()) == (1, 4, 8)
        monkeypatch.setenv("REPRO_TEST_LIST", "1,x7,4")
        with pytest.raises(ValueError, match=r"'x7'"):
            env_int_list("REPRO_TEST_LIST", ())
