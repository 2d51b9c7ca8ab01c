"""GPipe-style pipeline parallelism over one mesh axis of a
``torch.distributed`` world (the counterpart of ``repro.parallel.pipeline``).

The model's layer stack is split into S contiguous stages (S = size of the
pipeline axis); each rank runs the stage of its coordinate on that axis.
The schedule is JAX's GPipe fill-drain loop of M + S - 1 ticks, run by
every stage as the same program (SPMD):

  * stage 0 injects microbatch t (while t < M), every other stage takes
    the activation it received;
  * every stage applies its layers (in the bubble, to whatever it holds);
  * the last stage retires microbatch t - (S - 1) (once t >= S - 1);
  * one ring shift moves each stage's output to the next stage, the wrap
    from the last stage to stage 0 included, as JAX's ``ppermute`` does.

At the end the last stage's outputs go to every stage (a broadcast over
the axis: JAX's masked ``psum``, the same values).

Transport is point-to-point over the world's backend.  Under ``gloo``,
which moves host memory only, an activation on the card is staged through
a pinned host buffer on both sides, as ``stencil.distributed`` does.  A
pipeline axis of size 1 is a local wrap with no P2P op.

Counters (``step.stats``): calls, ticks, ring shifts (``p2p_ops``: one
send and one receive each, the counterpart of JAX's collective-permute)
and the bytes this rank sent.  Cost model: bubble fraction
(S - 1) / (M + S - 1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch.models.base import tree_map


def _axis_index(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no dim named {axis!r} (its dims: {names})")
    return names.index(axis)


class _Ring:
    """The pipeline axis as seen by this rank: its size, its stage, the
    axis's group and the global ranks of the next and previous stages."""

    def __init__(self, mesh, i: int):
        self.n, self.stage = mesh.size(i), mesh.get_local_rank(i)
        self.group = mesh.get_group(i) if self.n > 1 else None
        if self.group is not None:
            ranks = dist.get_process_group_ranks(self.group)
            self.ranks = ranks
            self.next = ranks[(self.stage + 1) % self.n]
            self.prev = ranks[(self.stage - 1) % self.n]
            self.staged = dist.get_backend(self.group) == "gloo"
        self._host = {}

    def _pinned(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _on_host(self, x: torch.Tensor) -> bool:
        return x.device.type != "cpu" and self.staged

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` to the next stage; return what the previous one sent."""
        if self.n == 1:
            return x                                 # the identity permutation
        if self._on_host(x):
            send = self._pinned("send", x)
            send.copy_(x)                            # synchronises the stream
            recv = self._pinned("recv", x)
        else:
            send, recv = x.contiguous(), torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, send, self.next, self.group),
               dist.P2POp(dist.irecv, recv, self.prev, self.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv.to(x.device) if self._on_host(x) else recv

    def from_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's ``x`` on every stage."""
        if self.n == 1:
            return x
        if self._on_host(x):
            host = self._pinned("bcast", x)
            if self.stage == self.n - 1:
                host.copy_(x)
            dist.broadcast(host, self.ranks[-1], group=self.group)
            return host.to(x.device)
        x = x.contiguous()
        dist.broadcast(x, self.ranks[-1], group=self.group)
        return x


def pipelined_forward(
    layer_fn: Callable,          # (layer_params, x) -> x  (one layer)
    stage_params,                # params with leading dim L/S (this stage's)
    x_microbatches,              # (M, mb, ...) microbatched inputs
    ring: _Ring,
    stats: dict,
):
    """Run the layer stack over all microbatches through the pipeline.

    Returns (M, mb, ...) outputs, valid on the LAST stage (other stages
    hold zeros); the caller broadcasts them."""
    S, stage = ring.n, ring.stage
    M = x_microbatches.shape[0]
    ticks = M + S - 1
    n_local = tree_leaves(stage_params)[0].shape[0]

    def stage_apply(x):
        for i in range(n_local):
            x = layer_fn(tree_map(lambda p: p[i], stage_params), x)
        return x

    buf = torch.zeros_like(x_microbatches)          # output collector
    state = torch.zeros_like(x_microbatches[0])     # in-flight activation
    for t in range(ticks):
        # stage 0 ingests microbatch t (if valid)
        injected = x_microbatches[t] if (stage == 0 and t < M) else state
        out = stage_apply(injected)
        # last stage retires microbatch t - (S-1)
        if stage == S - 1 and t >= S - 1:
            buf[t - (S - 1)] = out
        # shift boundary activations to the next stage
        state = ring.shift(out)
        stats["ticks"] += 1
        if S > 1:
            stats["p2p_ops"] += 1
            stats["bytes_sent"] += out.numel() * out.element_size()
    return buf


class PipelinedStep:
    """``step(stacked_params, x) -> y``: the layer stack over this rank's
    stage of the pipeline axis, on the whole batch ``x`` (every rank passes
    the same ``x`` and gets the same ``y``).  ``stats`` counts calls, ticks,
    ring shifts (``p2p_ops``) and bytes sent; ``reset_stats()`` zeroes
    them."""

    def __init__(self, layer_fn: Callable, n_layers: int, mesh, axis: str,
                 microbatches: int):
        i = _axis_index(mesh, axis)
        if n_layers % mesh.size(i):
            raise ValueError(f"{n_layers} layers not divisible into {mesh.size(i)} stages")
        self.ring = _Ring(mesh, i)
        self.layer_fn = layer_fn
        self.per_stage = n_layers // self.ring.n
        self.microbatches = microbatches
        self.stats = {"calls": 0, "ticks": 0, "p2p_ops": 0, "bytes_sent": 0}

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def __call__(self, params, x):
        self.stats["calls"] += 1
        lo = self.ring.stage * self.per_stage
        stage_params = tree_map(lambda p: p[lo:lo + self.per_stage], params)
        B = x.shape[0]
        if B % self.microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{self.microbatches} microbatches")
        xm = x.reshape(self.microbatches, B // self.microbatches, *x.shape[1:])
        out = pipelined_forward(self.layer_fn, stage_params, xm, self.ring,
                                self.stats)
        return self.ring.from_last(out).reshape(B, *x.shape[1:])


def make_pipelined_step(layer_fn, n_layers: int, mesh, axis: str = "pod",
                        microbatches: int = 4) -> PipelinedStep:
    """Build f(stacked_params, x) running layers split over ``axis``.

    stacked_params leaves have leading dim n_layers (every rank holds them;
    each uses its stage's slice, as views); x is (B, ...) and the same on
    every rank.  The batch is cut into ``microbatches`` along dim 0."""
    return PipelinedStep(layer_fn, n_layers, mesh, axis, microbatches)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
