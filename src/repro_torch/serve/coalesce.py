"""Request coalescing: group by plan signature, pad into batch buckets (a
copy of ``repro.serve.coalesce``; only :func:`stack_batch` differs).

The serving engine's whole premise is that traffic clusters on a handful
of plan signatures, so dispatch should amortize one batched launch over
every queued request that shares one.  This module is the pure-policy
half of that: :func:`coalesce` turns a drained queue into an ordered list
of :class:`Batch` objects, each holding requests of ONE signature padded
up to a power-of-two bucket size.  It never touches device state, which
is what makes the bucketing testable:

  * batches never mix plan signatures (a batched plan is specialized to
    one signature -- mixing would execute the wrong kernel);
  * bucket choice is a deterministic pure function of the request
    sequence and the knobs (no timestamps, no randomness), so a replayed
    queue coalesces identically;
  * padding is accounted per batch (``Batch.pad``) and stripped by the
    engine before any response -- padded slots can never leak.

Power-of-two buckets keep the number of DISTINCT batched plans per
signature logarithmic in the max batch (each (signature, bucket) pair is
its own plan-cache entry).

:func:`stack_batch` builds a torch tensor (numpy has no bfloat16), in
pinned host memory when the engine copies it to the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.envutil import env_int, env_int_list

#: Default bucket ladder: powers of two up to the default max batch.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)
#: Default cap on requests per batched launch.
DEFAULT_MAX_BATCH = 32
#: Default dispatcher linger: after the first request arrives, wait this
#: long for the queue to fill toward max_batch before launching.  0 means
#: dispatch whatever is queued immediately.
DEFAULT_QUEUE_TIMEOUT_MS = 2


def serve_buckets() -> Tuple[int, ...]:
    """The effective bucket ladder: ``REPRO_SERVE_BUCKETS`` (comma list of
    positive ints) if set, else :data:`DEFAULT_BUCKETS`; always returned
    sorted ascending with duplicates dropped."""
    return tuple(sorted(set(
        env_int_list("REPRO_SERVE_BUCKETS", DEFAULT_BUCKETS, minimum=1))))


def serve_max_batch() -> int:
    """``REPRO_SERVE_MAX_BATCH`` if set (positive int), else
    :data:`DEFAULT_MAX_BATCH`."""
    return env_int("REPRO_SERVE_MAX_BATCH", DEFAULT_MAX_BATCH, minimum=1)


def serve_queue_timeout_ms() -> int:
    """``REPRO_SERVE_QUEUE_TIMEOUT_MS`` if set (>= 0), else
    :data:`DEFAULT_QUEUE_TIMEOUT_MS`."""
    return env_int("REPRO_SERVE_QUEUE_TIMEOUT_MS",
                   DEFAULT_QUEUE_TIMEOUT_MS, minimum=0)


@dataclass
class ServeRequest:
    """One queued stencil request, signature-stamped at submit time.

    ``signature`` is the UNBATCHED plan-signature key
    (``repro_torch.kernels.plan.plan_signature`` without ``batch``) -- the
    coalescing identity.  ``plan_kwargs`` carries everything the engine
    needs to rebuild the plan per bucket (backend override, tile pins,
    device, compute_dtype, hw)."""

    x: object                      # the input grid (a torch tensor)
    weights: np.ndarray
    grid_shape: Tuple[int, ...]
    dtype: object
    t: int
    plan_kwargs: dict
    signature: tuple
    future: object                 # concurrent.futures.Future
    submit_s: float                # perf_counter stamp for latency
    seq: int                       # arrival order (deterministic tiebreak)


@dataclass
class Batch:
    """Requests of one plan signature, padded to ``bucket`` slots."""

    signature: tuple
    requests: List[ServeRequest]
    bucket: int

    @property
    def pad(self) -> int:
        """Padded slots executed but never returned to any caller."""
        return self.bucket - len(self.requests)

    @property
    def occupancy(self) -> float:
        """Useful fraction of the launch: 1.0 = no padding."""
        return len(self.requests) / self.bucket


def choose_bucket(n: int, buckets: Sequence[int], max_batch: int) -> int:
    """The bucket a group of ``n`` requests pads up to: the smallest
    allowed bucket >= ``n``.  Buckets above ``max_batch`` are never used;
    if the ladder has no entry >= ``n`` the largest allowed bucket is
    returned (callers chunk groups to that cap first).  Deterministic:
    depends only on the arguments."""
    if n < 1:
        raise ValueError(f"bucket request count must be >= 1, got {n}")
    allowed = [b for b in sorted(set(buckets)) if b <= max_batch]
    if not allowed:
        # ladder entirely above the cap: batches are exactly the cap
        return max_batch
    for b in allowed:
        if b >= n:
            return b
    return allowed[-1]


def coalesce(requests: Sequence[ServeRequest], *,
             buckets: Optional[Sequence[int]] = None,
             max_batch: Optional[int] = None) -> List[Batch]:
    """Turn a drained queue into signature-pure, bucket-padded batches.

    Requests are grouped by ``signature`` preserving arrival order (both
    across groups -- first-seen signature dispatches first -- and within
    a group), each group is chunked to at most ``cap = min(max_batch,
    largest allowed bucket)`` requests, and each chunk pads up to
    :func:`choose_bucket` of its length.  Pure function of
    ``(requests, buckets, max_batch)``.
    """
    if buckets is None:
        buckets = serve_buckets()
    if max_batch is None:
        max_batch = serve_max_batch()
    allowed = [b for b in sorted(set(buckets)) if b <= max_batch]
    cap = allowed[-1] if allowed else max_batch

    groups: Dict[tuple, List[ServeRequest]] = {}
    for req in requests:
        groups.setdefault(req.signature, []).append(req)

    out: List[Batch] = []
    for sig, reqs in groups.items():
        for lo in range(0, len(reqs), cap):
            chunk = reqs[lo:lo + cap]
            out.append(Batch(signature=sig, requests=chunk,
                             bucket=choose_bucket(len(chunk), buckets,
                                                  max_batch)))
    return out


def stack_batch(batch: Batch, pin: bool = False) -> torch.Tensor:
    """The batched input: request grids stacked along a new leading axis,
    padded slots filled with zero grids, as one host tensor (``pin``: in
    page-locked memory, so the engine's one copy to the card runs at full
    rate).  The engine slices responses to ``len(batch.requests)``, so
    padded outputs are computed (the launch shape is the bucket) but
    never observable.

    One ``torch.stack`` into the preallocated tensor copies the requests
    in a single call, and only the padded slots are zeroed: on a bucket of
    large grids the host's memory copies, not the kernel, set the pace."""
    first = batch.requests[0].x
    out = torch.empty((batch.bucket,) + tuple(first.shape), dtype=first.dtype,
                      pin_memory=pin)
    n = len(batch.requests)
    torch.stack([r.x.cpu() for r in batch.requests], out=out[:n])
    out[n:].zero_()
    return out
