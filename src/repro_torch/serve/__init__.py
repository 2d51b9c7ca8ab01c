"""repro_torch.serve: the batched plan-sharing serving engine (the
counterpart of ``repro.serve``).

Production stencil traffic is many concurrent small problems sharing a
handful of plan signatures.  This package runs them through a handful of
batched plans on the card:

  * ``coalesce``  -- group queued requests by plan signature and pad them
    into power-of-two batch buckets (``repro_torch.serve.coalesce``);
  * ``StencilServer`` -- the engine: ``submit`` returns a future, a
    dispatcher thread runs batched guarded plans (one launch per kernel
    call for the whole bucket, K11), and the card is synchronised once
    per batch, at the response boundary (``repro_torch.serve.engine``);
  * ``ServeMetrics`` -- requests/s, batch occupancy, and P50/P99 latency
    histograms (``repro_torch.serve.metrics``), dumped to
    BENCH_torch_serving.json by ``python -m repro_torch.benchmarks.serving``.

Knobs: ``REPRO_SERVE_BUCKETS``, ``REPRO_SERVE_MAX_BATCH``,
``REPRO_SERVE_QUEUE_TIMEOUT_MS`` (all via ``repro_torch.core.envutil``).
"""
from .coalesce import (Batch, ServeRequest, choose_bucket, coalesce,
                       serve_buckets, serve_max_batch,
                       serve_queue_timeout_ms, stack_batch)
from .engine import StencilServer
from .metrics import LatencyHistogram, ServeMetrics

__all__ = [
    "Batch", "LatencyHistogram", "ServeMetrics", "ServeRequest",
    "StencilServer", "choose_bucket", "coalesce", "serve_buckets",
    "serve_max_batch", "serve_queue_timeout_ms", "stack_batch",
]
