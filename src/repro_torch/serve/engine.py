"""The serving engine: submit -> coalesce -> batched guarded plans (the
counterpart of ``repro.serve.engine``).

:class:`StencilServer` is the subsystem's hot loop.  ``submit`` stamps
the request with its unbatched plan signature and returns a
``concurrent.futures.Future`` immediately; a dispatcher thread drains the
queue (lingering up to ``queue_timeout_ms`` for the queue to fill toward
``max_batch``), coalesces by signature into power-of-two buckets
(``repro_torch.serve.coalesce``), and executes each bucket through ONE
batched plan -- ``stencil_plan(..., batch=B)``, guarded by default, so the
degradation ladder applies per batch and a kernel that fails to build or
launch demotes the bucket instead of crashing the server.

On the card (``device=None``, the default) a batch costs one host-to-device
copy of the stacked grids (pinned), the batched plan's launches -- one per
kernel call (K11) under ``batch_mode="auto"`` --, one
``torch.cuda.synchronize`` at the response boundary (the JAX
``block_until_ready``; a guarded plan synchronises inside its call, and
the engine's then finds the card idle) and one device-to-host copy
into pinned memory.  Responses are CPU tensors sliced from that copy, not numpy arrays as in
JAX, because numpy has no bfloat16.  ``device="cpu"`` runs the plain
versions (tests).

Plan reuse happens at two levels: the engine keeps its own
(signature, bucket) -> plan table (steady-state dispatch is one dict hit),
and the table populates through the process-wide plan LRU, whose lock
makes that safe from the dispatcher thread.

Caller bugs stay in the caller: ``submit`` validates arguments through
``plan_signature`` synchronously and raises there; only *kernel* failures
reach the guarded dispatch path.  A batch whose every rung fails resolves
each of its futures with the terminal ``GuardedExecutionError`` -- the
dispatcher thread itself never dies, and never carries on on the CPU.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.kernels import guard as _guard
from repro_torch.kernels import plan as _plan
from .coalesce import (Batch, ServeRequest, coalesce, serve_buckets,
                       serve_max_batch, serve_queue_timeout_ms, stack_batch)
from .metrics import ServeMetrics


class StencilServer:
    """Batched plan-sharing stencil server.

    Args:
      device: where every plan runs; ``None`` = the card (raises when
        there is none), ``"cpu"`` = the plain versions.
      max_batch: cap on requests per batched launch (None = the
        ``REPRO_SERVE_MAX_BATCH`` knob).
      buckets: allowed batch bucket ladder (None = ``REPRO_SERVE_BUCKETS``).
      queue_timeout_ms: dispatcher linger after the first queued request
        (None = ``REPRO_SERVE_QUEUE_TIMEOUT_MS``); 0 dispatches whatever
        is queued the moment the dispatcher wakes.
      guard: route batches through :func:`guarded_stencil_plan` (default).
        ``False`` executes raw plans -- kernel failures then fail the
        affected futures with the raw exception.
      watchdog: NaN/Inf watchdog for guarded batches (None = the
        ``REPRO_NAN_WATCHDOG`` env flag).
      hw: hardware model consulted by the selector for every plan.
      batch_mode / compute_dtype: forwarded to every plan.

    Use as a context manager or call :meth:`shutdown`; queued requests
    are drained (never dropped) on shutdown.
    """

    def __init__(self, *,
                 device=None,
                 max_batch: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 queue_timeout_ms: Optional[int] = None,
                 guard: bool = True,
                 watchdog: Optional[bool] = None,
                 hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
                 batch_mode: str = "auto",
                 compute_dtype=None):
        self.device = _plan.resolve_device(device)
        self.max_batch = serve_max_batch() if max_batch is None \
            else int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.buckets = serve_buckets() if buckets is None \
            else tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, "
                             f"got {self.buckets}")
        timeout_ms = serve_queue_timeout_ms() if queue_timeout_ms is None \
            else int(queue_timeout_ms)
        if timeout_ms < 0:
            raise ValueError(f"queue_timeout_ms must be >= 0, "
                             f"got {timeout_ms}")
        self.queue_timeout_s = timeout_ms / 1e3
        self.guard = bool(guard)
        self.watchdog = watchdog
        self.hw = hw
        self.batch_mode = batch_mode
        self.compute_dtype = compute_dtype

        self.metrics = ServeMetrics()
        self._cv = threading.Condition()
        self._queue: List[ServeRequest] = []
        self._seq = 0
        self._stopping = False
        # (signature, bucket) -> plan; touched ONLY by the dispatcher
        # thread, so no lock -- the process-wide plan LRU underneath has
        # its own.
        self._plans: Dict[Tuple[tuple, int], object] = {}
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="repro-torch-serve-dispatch",
            daemon=True)
        self._dispatcher.start()

    # -- client side -----------------------------------------------------
    def submit(self, weights, x, t: int = 1, **plan_kwargs) -> Future:
        """Queue one request; returns its future.

        ``weights``/``t``/``plan_kwargs`` mirror ``stencil_plan`` (backend
        override, tile pins, ...); the grid shape and dtype come from
        ``x`` itself (a torch tensor, or a numpy array).  Argument errors
        raise HERE, in the caller's thread -- a request that cannot even
        be keyed never enters the queue."""
        if self._stopping:
            raise RuntimeError("StencilServer is shut down")
        for k in ("batch", "batch_mode", "mesh", "shard_spec"):
            if k in plan_kwargs:
                raise ValueError(f"submit() forbids {k!r}: batching is the "
                                 "engine's job and meshes do not compose "
                                 "with batched serving")
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        kwargs = dict(plan_kwargs)
        kwargs.setdefault("hw", self.hw)
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("compute_dtype", self.compute_dtype)
        key, w, grid_shape, dtype, _ = _plan.plan_signature(
            weights, tuple(x.shape), x.dtype, t, **kwargs)

        fut: Future = Future()
        with self._cv:
            if self._stopping:
                raise RuntimeError("StencilServer is shut down")
            req = ServeRequest(
                x=x, weights=w, grid_shape=grid_shape, dtype=dtype, t=t,
                plan_kwargs=kwargs, signature=key, future=fut,
                submit_s=time.perf_counter(), seq=self._seq)
            self._seq += 1
            self._queue.append(req)
            # Wake the dispatcher only at the edges that matter: the
            # empty->non-empty transition (it may be idle) and hitting the
            # fill target (it may be lingering); notifying on every submit
            # turns the linger into a wakeup storm.
            n = len(self._queue)
            if n == 1 or n >= self.max_batch:
                self._cv.notify()
        return fut

    # -- lifecycle -------------------------------------------------------
    def shutdown(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests, drain the queue, join the dispatcher."""
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            self._cv.notify_all()
        self._dispatcher.join(timeout)

    def __enter__(self) -> "StencilServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    def stats(self) -> dict:
        """Metrics snapshot plus plan bookkeeping (engine table size and
        the process-wide plan-cache counters)."""
        out = self.metrics.snapshot()
        out["engine_plans"] = len(self._plans)
        out["plan_cache"] = _plan.plan_cache_stats()
        return out

    # -- dispatcher side -------------------------------------------------
    def _drain(self) -> List[ServeRequest]:
        """Block until work exists (or shutdown), linger up to the queue
        timeout for the batch to fill, then take the whole queue."""
        with self._cv:
            while not self._queue:
                if self._stopping:
                    return []
                self._cv.wait(timeout=0.05)
            if self.queue_timeout_s > 0:
                deadline = time.perf_counter() + self.queue_timeout_s
                while (len(self._queue) < self.max_batch
                       and not self._stopping):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            drained, self._queue = self._queue, []
            return drained

    def _dispatch_loop(self) -> None:
        while True:
            drained = self._drain()
            if not drained:
                return                     # stopping and queue empty
            for batch in coalesce(drained, buckets=self.buckets,
                                  max_batch=self.max_batch):
                self._execute(batch)

    def _plan_for(self, batch: Batch):
        key = (batch.signature, batch.bucket)
        plan = self._plans.get(key)
        if plan is None:
            lead = batch.requests[0]
            kw = dict(lead.plan_kwargs)
            hw = kw.pop("hw", self.hw)
            if self.guard:
                plan = _guard.guarded_stencil_plan(
                    lead.weights, lead.grid_shape, lead.dtype, lead.t,
                    watchdog=self.watchdog, hw=hw, batch=batch.bucket,
                    batch_mode=self.batch_mode, **kw)
            else:
                plan = _plan.stencil_plan(
                    lead.weights, lead.grid_shape, lead.dtype, lead.t,
                    hw=hw, batch=batch.bucket, batch_mode=self.batch_mode,
                    **kw)
            self._plans[key] = plan
        return plan

    def _execute(self, batch: Batch) -> None:
        # submission accounting lands here, at dispatch, derived from the
        # drained requests -- counted whether the batch then succeeds or
        # fails, so submitted == responded + failed once the queue drains
        self.metrics.record_submits(
            batch.signature, len(batch.requests),
            min(req.submit_s for req in batch.requests))
        dev = batch.requests[0].plan_kwargs["device"]
        on_card = torch.device(dev).type == "cuda"
        try:
            plan = self._plan_for(batch)
            xb = stack_batch(batch, pin=on_card)
            yb = plan(xb.to(dev, non_blocking=True) if on_card else xb)
            if on_card:
                # One device->host copy for the whole batch, into pinned
                # memory (a pageable copy runs at a fraction of the link's
                # rate), then THE response boundary: one device sync per
                # batch.
                yd, yb = yb, torch.empty(yb.shape, dtype=yb.dtype,
                                         pin_memory=True)
                yb.copy_(yd, non_blocking=True)
                torch.cuda.synchronize(dev)
        except Exception as exc:  # noqa: BLE001 -- resolves futures, never dies
            self.metrics.record_failure(len(batch.requests))
            for req in batch.requests:
                if not req.future.cancelled():
                    req.future.set_exception(exc)
            return
        done_s = time.perf_counter()
        # the batch is recorded before its futures resolve, so a client
        # that has every result reads a snapshot that counts them all
        self.metrics.record_responses(
            [done_s - req.submit_s for req in batch.requests])
        self.metrics.record_batch(len(batch.requests), batch.bucket,
                                  degraded=bool(getattr(plan, "degraded",
                                                        False)))
        # strip padding: slots >= len(requests) are never observable
        for i, req in enumerate(batch.requests):
            if not req.future.cancelled():
                req.future.set_result(yb[i])
