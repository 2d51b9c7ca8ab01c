"""Serving metrics: requests/s, batch occupancy, P50/P99 latency (a copy
of ``repro.serve.metrics``).

Latencies land in a fixed log2 histogram (:class:`LatencyHistogram`) --
bounded memory at millions of requests, unlike a reservoir -- with exact
count/sum/min/max kept alongside so the mean is not quantized.
Percentiles interpolate linearly inside the winning bucket, which bounds
the error to one bucket width (a factor of 2 in latency); for serving
dashboards that resolution is the standard trade (HDR-histogram style).

:class:`ServeMetrics` is the engine-facing aggregate: thread-safe (the
dispatcher records completions while clients record submissions), cheap
to record into (one lock, O(1) work), and ``snapshot()`` emits the
JSON-ready dict ``repro_torch.benchmarks.serving`` dumps into
BENCH_torch_serving.json.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

#: Histogram buckets: bucket ``i`` holds latencies in [2^i, 2^(i+1)) us.
#: 40 buckets span 1 us .. ~12.7 days -- nothing a serving path can
#: produce falls off either end (sub-us clamps into bucket 0).
_N_BUCKETS = 40


class LatencyHistogram:
    """Fixed-size log2 latency histogram over microseconds.

    Not thread-safe on its own -- :class:`ServeMetrics` serializes access;
    standalone users (tests, benchmarks) record from one thread.
    """

    def __init__(self):
        self.counts: List[int] = [0] * _N_BUCKETS
        self.count = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    @staticmethod
    def _bucket(seconds: float) -> int:
        us = seconds * 1e6
        if us < 1.0:
            return 0
        return min(int(math.log2(us)), _N_BUCKETS - 1)

    def record(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"latency must be >= 0, got {seconds}")
        self.counts[self._bucket(seconds)] += 1
        self.count += 1
        self.sum_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    def percentile(self, q: float) -> float:
        """The latency (seconds) at quantile ``q`` in [0, 1]: linear
        interpolation inside the bucket holding the q-th record, clamped
        to the observed min/max so tiny samples stay sane."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo, hi = float(2 ** i), float(2 ** (i + 1))
                frac = (rank - seen) / c
                est = (lo + frac * (hi - lo)) * 1e-6
                return min(max(est, self.min_s), self.max_s)
            seen += c
        return self.max_s

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "count": self.count,
            "mean_ms": (self.sum_s / self.count * 1e3) if self.count else 0.0,
            "min_ms": (self.min_s * 1e3) if self.count else 0.0,
            "max_ms": self.max_s * 1e3,
            "p50_ms": self.percentile(0.50) * 1e3,
            "p99_ms": self.percentile(0.99) * 1e3,
            # only the occupied buckets, upper-edge labeled
            "buckets": [{"le_us": 2 ** (i + 1), "count": c}
                        for i, c in enumerate(self.counts) if c],
        }
        return out


class ServeMetrics:
    """Thread-safe serving aggregate: latency histogram + throughput +
    batch-occupancy accounting.

    The wall-clock window for requests/s runs from the first submit to
    the last response (both recorded here), so a snapshot taken mid-burst
    and one taken after drain agree on the completed-request rate.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._lat = LatencyHistogram()
        self._submitted = 0
        self._responded = 0
        self._failed = 0
        self._batches = 0
        self._batch_slots = 0      # sum of bucket sizes launched
        self._padded_slots = 0
        self._degraded_batches = 0
        self._signatures = set()
        self._first_submit_s: Optional[float] = None
        self._last_response_s: Optional[float] = None

    # -- recording (engine + submit path) -------------------------------
    def record_submit(self, signature: tuple) -> None:
        with self._lock:
            self._submitted += 1
            self._signatures.add(signature)
            if self._first_submit_s is None:
                self._first_submit_s = time.perf_counter()

    def record_submits(self, signature: tuple, n: int,
                       first_submit_s: float) -> None:
        """Batch variant, called by the DISPATCHER when a batch launches
        rather than by clients per request: the submit path stays
        lock-free (its cost is paid on every request of every client),
        and everything here -- count, signature, the earliest submit
        stamp -- is derivable from the drained requests themselves."""
        with self._lock:
            self._submitted += n
            self._signatures.add(signature)
            if self._first_submit_s is None \
                    or first_submit_s < self._first_submit_s:
                self._first_submit_s = first_submit_s

    def record_batch(self, n_requests: int, bucket: int,
                     degraded: bool = False) -> None:
        with self._lock:
            self._batches += 1
            self._batch_slots += bucket
            self._padded_slots += bucket - n_requests
            if degraded:
                self._degraded_batches += 1

    def record_response(self, latency_s: float) -> None:
        with self._lock:
            self._lat.record(latency_s)
            self._responded += 1
            self._last_response_s = time.perf_counter()

    def record_responses(self, latencies_s) -> None:
        """Batch variant: one lock round-trip for a whole batch's worth
        of completions (the engine resolves batches, not requests)."""
        with self._lock:
            for latency_s in latencies_s:
                self._lat.record(latency_s)
            self._responded += len(latencies_s)
            self._last_response_s = time.perf_counter()

    def record_failure(self, n_requests: int = 1) -> None:
        with self._lock:
            self._failed += n_requests

    # -- reading ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready aggregate; atomic under the lock."""
        with self._lock:
            window_s = 0.0
            if self._first_submit_s is not None \
                    and self._last_response_s is not None:
                window_s = max(self._last_response_s - self._first_submit_s,
                               0.0)
            occ = ((self._batch_slots - self._padded_slots)
                   / self._batch_slots) if self._batch_slots else 0.0
            return {
                "submitted": self._submitted,
                "responded": self._responded,
                "failed": self._failed,
                "distinct_signatures": len(self._signatures),
                "batches": self._batches,
                "batch_slots": self._batch_slots,
                "padded_slots": self._padded_slots,
                "batch_occupancy": occ,
                "degraded_batches": self._degraded_batches,
                "window_s": window_s,
                "requests_per_s": (self._responded / window_s)
                                  if window_s > 0 else 0.0,
                "latency": self._lat.snapshot(),
            }

    def reset(self) -> None:
        """Back to pristine (benchmark warmup hygiene); keeps the lock."""
        with self._lock:
            self._lat = LatencyHistogram()
            self._submitted = self._responded = self._failed = 0
            self._batches = self._batch_slots = self._padded_slots = 0
            self._degraded_batches = 0
            self._signatures = set()
            self._first_submit_s = None
            self._last_response_s = None
