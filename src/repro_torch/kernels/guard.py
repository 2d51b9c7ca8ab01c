"""Guarded plan execution: failure taxonomy and deterministic degradation
ladder (the counterpart of ``repro.kernels.guard``).

A deployment that runs a stencil for millions of steps cannot crash on
the first kernel that fails to build or launch.  This module makes every
plan build and step survivable:

Taxonomy
  Raw exceptions are classified by cause into :class:`PlanBuildError`,
  :class:`KernelCompileError` (``nvcc`` failed, or a launch was refused
  for another reason), :class:`VmemOverflowError` (a block asked for more
  shared memory or registers than the SM has -- CUDA's "too many
  resources requested for launch" -- or the card ran out of memory),
  :class:`NumericalFaultError`, :class:`HaloExchangeError`, all
  subclasses of :class:`GuardedExecutionError` carrying ``.cause``.  The
  JAX package's spellings (Mosaic, XLA, RESOURCE_EXHAUSTED) classify the
  same way.

Degradation ladder
  On failure, a :class:`GuardedPlan` retries deterministically:

    requested backend, normal tile
      -> same backend, DEGRADED tile (pins dropped, the tile rule's
         shared-memory budget ``REPRO_VMEM_BUDGET`` halved, so
         ``resolve_tile_geom`` picks a smaller tile)
      -> registry backends by ``fallback_rank``
         (fused_matmul_reuse -> fused_sparse_matmul -> sparse_matmul
          -> fused_matmul -> matmul -> fused_direct -> direct
          -> fused_direct_wholestrip -> direct_wholestrip [-> reference])

  The plain ``reference`` is a rung only of plans on the CPU, where every
  rung runs its plain version anyway.  On the card the ladder ends at the
  last kernel rung, ``direct_wholestrip``, and a failure there raises
  :class:`GuardedExecutionError` with the ``history``: no guarded plan
  on the card carries on in plain PyTorch.

  Each rung failure is classified, recorded in the
  :mod:`repro_torch.core.events` ring buffer and noted in the plan
  module's negative-result registry (``note_plan_failure``): the LRU never
  keeps a failed signature, and a repeat request skips known-bad rungs
  (``failed_plan``).  The ladder is a pure function of the plan signature
  and the process env, so every rank of a distributed plan's mesh sees
  the same signature and environment and lands on the same rung without
  communicating (``guarded_stencil_plan(mesh=, shard_spec=,
  dist_mode=)`` carries the mesh through every rung).

Watchdog
  Opt-in (``watchdog=True`` or ``REPRO_NAN_WATCHDOG=1``): each guarded
  step's output is checked for NaN/Inf; a fault records a
  :class:`NumericalFaultError` event and demotes the rung for later
  calls.  The faulty step is re-run through the reference backend on the
  CPU, and on the next kernel rung on the card (if none is left, the
  :class:`NumericalFaultError` is raised).

Sticky CUDA errors
  An illegal address, a misaligned access, an illegal instruction, a
  device-side assert or an unspecified launch failure poisons the CUDA
  context: every later call on it fails, so no rung can recover.  The
  guard classifies such an error as :class:`DeviceFaultError`, records
  it, and re-raises it instead of walking the ladder.

Every guarded step synchronises the card, so a fault inside a kernel
surfaces in the step that launched it.  A clean run records nothing,
skips nothing, and returns the *identical* cached plan object an
unguarded ``stencil_plan`` call would.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import events as _events
from repro_torch.core.envutil import env_flag
from repro_torch.testing import faults as _faults
from . import plan as _plan
from . import registry
from .common import smem_budget_bytes


# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------
class GuardedExecutionError(RuntimeError):
    """Base of the guard taxonomy; ``cause`` is the machine-readable tag
    recorded in events and negative-cache entries."""

    cause = "unknown"

    def __init__(self, message: str, *, backend: Optional[str] = None,
                 stage: Optional[str] = None):
        super().__init__(message)
        self.backend = backend
        self.stage = stage


class PlanBuildError(GuardedExecutionError):
    """Host-side plan construction failed (sizing, validation, weight
    composition) before any kernel ran."""

    cause = "plan_build"


class KernelCompileError(GuardedExecutionError):
    """The kernel failed to build (``nvcc``), or its launch was refused for
    a reason other than resources."""

    cause = "compile"


class VmemOverflowError(GuardedExecutionError):
    """The launch asked for more on-chip memory than the SM has (CUDA's
    "too many resources requested for launch"; the JAX package's VMEM
    overflow), or the card ran out of memory: degrade the tile."""

    cause = "vmem"


class NumericalFaultError(GuardedExecutionError):
    """A step produced NaN/Inf (watchdog)."""

    cause = "numerical"


class HaloExchangeError(GuardedExecutionError):
    """The distributed halo exchange failed: a send or receive of the
    stepper's rings (gloo's and ``torch.distributed``'s own errors,
    ``torch.distributed.DistError``) or the injected ``halo`` fault."""

    cause = "halo"


class DeviceFaultError(GuardedExecutionError):
    """A sticky CUDA error poisoned the context (module docstring): no
    rung can run after it, so the guard re-raises it."""

    cause = "device"


#: Message fragments -> taxonomy, checked in order (most specific first):
#: the port's own failures (``kernels/_build.py``'s nvcc and launch
#: errors, ``csrc/common.cuh::prepare_launch``'s attribute errors, CUDA's
#: error strings) and the JAX package's spellings, which the injected
#: faults of both packages mimic.
_STICKY_MARKERS = ("illegal memory access", "illegal address",
                   "misaligned address", "illegal instruction",
                   "unspecified launch failure", "device-side assert",
                   "hardware stack error", "invalid program counter")
_VMEM_MARKERS = ("too many resources requested", "out of resources",
                 "out of memory", "shared memory", "resource_exhausted",
                 "vmem", "scratch", "memory space")
_COMPILE_MARKERS = ("nvcc", "ptxas", "failed to build", "launch failed",
                    "no kernel image", "mosaic", "failed to compile",
                    "lowering", "unsupported", "internal:", "xla", "pallas",
                    "unimplemented", "mlir")
_HALO_MARKERS = ("halo exchange", "ppermute", "collective", "gloo",
                 "connection closed by peer", "connection reset by peer",
                 "timed out waiting")
_NUMERIC_MARKERS = ("nan", "non-finite", "not finite", "inf produced")


def classify_failure(exc: BaseException,
                     stage: str = "execute",
                     backend: Optional[str] = None) -> GuardedExecutionError:
    """Wrap a raw exception in its taxonomy class (never raises).

    ``stage`` breaks ties when the message matches nothing: ``"build"``
    failures become :class:`PlanBuildError`, anything at launch time
    defaults to :class:`KernelCompileError` (retrying a different regime
    is always legal).
    """
    if isinstance(exc, GuardedExecutionError):
        return exc
    msg = str(exc)
    low = msg.lower()
    if any(m in low for m in _STICKY_MARKERS):
        cls = DeviceFaultError
    elif (isinstance(exc, torch.distributed.DistError)
          or any(m in low for m in _HALO_MARKERS)):
        cls = HaloExchangeError
    elif (isinstance(exc, torch.cuda.OutOfMemoryError)
          or any(m in low for m in _VMEM_MARKERS)):
        cls = VmemOverflowError
    elif any(m in low for m in _NUMERIC_MARKERS):
        cls = NumericalFaultError
    elif any(m in low for m in _COMPILE_MARKERS):
        cls = KernelCompileError
    elif stage == "build":
        cls = PlanBuildError
    else:
        cls = KernelCompileError
    err = cls(f"[{cls.cause}] {msg}", backend=backend, stage=stage)
    err.__cause__ = exc
    return err


# ---------------------------------------------------------------------------
# Ladder construction
# ---------------------------------------------------------------------------
#: The plan arguments the degraded rung drops, so the tile re-resolves.
_PINS = ("tile_m", "w_tile", "z_slab")


class _Rung:
    """One ladder position: a backend override + tile mode."""

    __slots__ = ("backend", "degraded")

    def __init__(self, backend: Optional[str], degraded: bool):
        self.backend = backend      # None = auto (selector decides)
        self.degraded = degraded

    def label(self, resolved: Optional[str] = None) -> str:
        name = self.backend or (f"auto:{resolved}" if resolved else "auto")
        return f"{name}+degraded" if self.degraded else name

    def __repr__(self):
        return f"_Rung({self.label()!r})"


class _EnvPin:
    """Temporarily pin REPRO_VMEM_BUDGET (the degraded rung): the tile rule
    re-resolves under the smaller budget and the value lands in the plan
    key, so degraded plans never alias normal ones.  Restores the prior
    value even on failure."""

    def __init__(self, budget: Optional[int]):
        self._budget = budget
        self._prior = None
        self._had = False

    def __enter__(self):
        if self._budget is not None:
            self._had = "REPRO_VMEM_BUDGET" in os.environ
            self._prior = os.environ.get("REPRO_VMEM_BUDGET")
            os.environ["REPRO_VMEM_BUDGET"] = str(self._budget)
        return self

    def __exit__(self, *exc):
        if self._budget is not None:
            if self._had:
                os.environ["REPRO_VMEM_BUDGET"] = self._prior
            else:
                os.environ.pop("REPRO_VMEM_BUDGET", None)
        return False


def _start_backend(weights, grid_shape, dtype, t, hw, backend, tile_m,
                   w_tile, use_sparse_unit=False, boundary=None, z_slab=None):
    """The name the first rung executes: the override if given, else the
    selector's pick (``plan.auto_decision``, as ``stencil_plan`` takes
    it).  ``None`` when even pricing fails (then the walk uses the full
    ladder)."""
    if backend is not None:
        return backend
    try:
        return _plan.auto_decision(
            _plan.spec_from_weights(weights), grid_shape, dtype, t, hw=hw,
            tile_m=tile_m, w_tile=w_tile, z_slab=z_slab,
            use_sparse_unit=use_sparse_unit, boundary=boundary)[1].backend
    except Exception:
        return None


def _on_card(device) -> bool:
    """Whether a plan for ``device`` (``None`` = the card) runs on it."""
    return _plan.resolve_device(device).type == "cuda"


def _ladder(requested: Optional[str], start: Optional[str],
            on_card: bool) -> List[_Rung]:
    """The rungs of a guarded plan: ``requested`` (None = auto) at its
    tile and degraded, then the registry's ladder below ``start``.  The
    plain ``reference`` ends the ladder on the CPU; on the card it is a
    rung only when the caller asked for it."""
    rungs = [_Rung(requested, False), _Rung(requested, True)]
    for name in registry.fallback_ladder(after=start):
        if name != "reference" or not on_card:
            rungs.append(_Rung(name, False))
    if not on_card and not any(r.backend == "reference" for r in rungs):
        rungs.append(_Rung("reference", False))     # terminal rung
    return rungs


# ---------------------------------------------------------------------------
# GuardedPlan
# ---------------------------------------------------------------------------
class GuardedPlan:
    """A StencilPlan wrapper that survives failures by walking the
    degradation ladder.  Mirrors the plan API (``__call__``/``step``/
    ``run``/``explain``) and exposes:

      * ``plan``     -- the live underlying :class:`StencilPlan`;
      * ``backend``  -- the backend actually executing right now;
      * ``degraded`` -- True once any ladder move happened;
      * ``history``  -- ``[{"rung", "cause", "error"}]`` of failed rungs;
      * ``on_card``  -- the plan runs on the card (no plain rung).
    """

    def __init__(self, plan_args: tuple, plan_kwargs: dict,
                 watchdog: Optional[bool] = None):
        self._args = plan_args          # (spec_or_weights, grid, dtype, t)
        self._kwargs = dict(plan_kwargs)
        if watchdog is None:
            watchdog = env_flag("REPRO_NAN_WATCHDOG", False)
        self.watchdog = bool(watchdog)
        self.history: List[dict] = []

        weights = plan_args[0]
        from repro_torch.stencil.spec import StencilSpec
        if isinstance(weights, StencilSpec):
            from repro_torch.stencil.weights import jacobi_weights
            weights = jacobi_weights(weights)
        self._start = _start_backend(
            np.asarray(weights), plan_args[1], plan_args[2], plan_args[3],
            self._hw(), self._kwargs.get("backend"),
            self._kwargs.get("tile_m"), self._kwargs.get("w_tile"),
            self._kwargs.get("use_sparse_unit", False),
            self._kwargs.get("boundary"), self._kwargs.get("z_slab"))

        self.on_card = _on_card(self._kwargs.get("device"))
        self._rungs = _ladder(self._kwargs.get("backend"), self._start,
                              self.on_card)
        self._idx = 0
        self._plan = None
        self._checked = None            # lazily built reference re-run plan
        self._build_current()

    # -- rung plumbing --------------------------------------------------
    def _hw(self):
        return self._kwargs.get("hw", _plan.pm.H100_SXM_DATASHEET)

    def _rung_call_kwargs(self, rung: _Rung) -> dict:
        kw = dict(self._kwargs)
        kw["backend"] = rung.backend
        if rung.degraded:
            # Degraded tile: drop the pins so the tile rule re-sizes under
            # the halved budget _EnvPin sets.  ``boundary`` is semantics,
            # not geometry: every rung (and the checked re-run) keeps it.
            for g in _PINS:
                kw[g] = None
        kw.pop("hw", None)
        return kw

    def _rung_env(self, rung: _Rung) -> _EnvPin:
        if not rung.degraded:
            return _EnvPin(None)
        return _EnvPin(max(smem_budget_bytes() // 2, 1))

    def _rung_key(self, rung: _Rung):
        kw = self._rung_call_kwargs(rung)
        kw.pop("use_cache", None)
        return _plan.plan_signature(*self._args, hw=self._hw(), **kw)[0]

    def _note_failure(self, rung: _Rung, err: GuardedExecutionError,
                      stage: str) -> None:
        with self._rung_env(rung):
            key = self._rung_key(rung)
        _plan.note_plan_failure(key, err.cause, rung.label(self._start),
                                stage=stage)
        self.history.append({"rung": rung.label(self._start),
                             "cause": err.cause,
                             "error": str(err)[:200]})
        _events.record("guard_failure", cause=err.cause,
                       rung=rung.label(self._start), stage=stage,
                       error=str(err)[:200])

    def _fail(self, rung: _Rung, exc: BaseException, stage: str) -> None:
        """Classify and record a rung's failure, then move down the ladder
        -- or, for a sticky CUDA error, re-raise it classified."""
        err = classify_failure(exc, stage=stage,
                               backend=rung.label(self._start))
        if isinstance(err, DeviceFaultError):
            _events.record("guard_failure", cause=err.cause,
                           rung=rung.label(self._start), stage=stage,
                           error=str(err)[:200])
            raise err
        self._note_failure(rung, err, stage=stage)
        self._advance(rung)

    def _exhausted(self, why: str) -> GuardedExecutionError:
        err = GuardedExecutionError(
            f"degradation ladder exhausted: {why}; failed rungs: "
            + "; ".join(f"{h['rung']} ({h['cause']})" for h in self.history)
            + " (plan_cache_stats() and repro_torch.core.events hold the "
            "record)")
        err.history = list(self.history)
        return err

    def _advance(self, rung: _Rung) -> None:
        self._idx += 1
        if self._idx >= len(self._rungs):
            raise self._exhausted("no rung survived")
        _plan.record_fallback()
        _events.record("guard_fallback", frm=rung.label(self._start),
                       to=self._rungs[self._idx].label(self._start))

    def _build_current(self) -> None:
        """Build the plan for the current rung, advancing past rungs whose
        build fails or whose signature is already known-bad."""
        while True:
            rung = self._rungs[self._idx]
            with self._rung_env(rung):
                key = self._rung_key(rung)
                neg = _plan.failed_plan(key)
                if neg is not None:
                    _events.record("guard_skip", rung=rung.label(self._start),
                                   cause=neg["cause"])
                    self._idx += 1
                    if self._idx >= len(self._rungs):
                        raise self._exhausted(
                            "every rung left is negative-cached; "
                            "clear_plan_cache() to retry")
                    continue
                try:
                    self._plan = _plan.stencil_plan(
                        *self._args, hw=self._hw(),
                        **self._rung_call_kwargs(rung))
                    return
                except Exception as exc:  # noqa: BLE001 -- classified
                    self._fail(rung, exc, "build")

    # -- introspection --------------------------------------------------
    @property
    def plan(self):
        return self._plan

    @property
    def backend(self) -> str:
        return self._plan.backend

    @property
    def degraded(self) -> bool:
        return self._idx > 0

    @property
    def rung(self) -> str:
        return self._rungs[self._idx].label(self._start)

    @property
    def grid_shape(self):
        return self._plan.grid_shape

    @property
    def batch(self):
        return self._plan.batch

    @property
    def input_shape(self):
        return self._plan.input_shape

    @property
    def decision(self):
        return self._plan.decision

    def explain(self) -> str:
        lines = [self._plan.explain()]
        if self.degraded:
            lines.append(f"  guard    : DEGRADED to rung {self.rung!r} "
                         f"after {len(self.history)} failure(s)")
            for h in self.history:
                lines.append(f"    - {h['rung']}: {h['cause']} "
                             f"({h['error'][:80]})")
        else:
            lines.append("  guard    : clean (no degradation)")
        return "\n".join(lines)

    def __repr__(self):
        return (f"GuardedPlan(rung={self.rung!r}, degraded={self.degraded}, "
                f"failures={len(self.history)})")

    # -- execution ------------------------------------------------------
    def _checked_rerun(self, x):
        """Re-run one step through the reference backend (the watchdog's
        recovery path on the CPU; it never passes a fault hook)."""
        if self._checked is None:
            kw = dict(self._kwargs)
            kw.pop("hw", None)
            kw.pop("use_cache", None)
            for g in _PINS:
                kw.pop(g, None)
            kw["backend"] = "reference"
            self._checked = _plan.stencil_plan(*self._args, hw=self._hw(),
                                               **kw)
        return self._checked(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self._plan.input_shape:
            # caller bug, not a kernel failure: propagate raw
            return self._plan(x)
        while True:
            rung = self._rungs[self._idx]
            try:
                y = _faults.corrupt_output(self._plan(x))
                if y.is_cuda:
                    torch.cuda.synchronize(y.device)
            except Exception as exc:  # noqa: BLE001 -- classified
                self._fail(rung, exc, "execute")
                self._build_current()
                continue
            if self.watchdog and not bool(torch.isfinite(y).all()):
                err = NumericalFaultError(
                    f"[numerical] NaN/Inf in step output "
                    f"(backend {self.backend!r})",
                    backend=rung.label(self._start), stage="execute")
                self._note_failure(rung, err, stage="execute")
                if self.on_card:
                    # no plain re-run on the card: demote, and re-run the
                    # step on the next kernel rung (or raise the fault)
                    _events.record("guard_watchdog",
                                   rung=rung.label(self._start),
                                   action="next_rung")
                    if self._idx + 1 >= len(self._rungs):
                        raise err
                    self._advance(rung)
                    self._build_current()
                    continue
                _events.record("guard_watchdog",
                               rung=rung.label(self._start),
                               action="checked_rerun")
                y = self._checked_rerun(x)
                # demote for later calls; this step already recovered
                self._advance(rung)
                self._build_current()
            return y

    def step(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    def run(self, x: torch.Tensor, n_steps: int) -> torch.Tensor:
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        for _ in range(n_steps):
            x = self(x)
        return x


def guarded_stencil_plan(spec_or_weights, grid_shape, dtype, t: int = 1,
                         *, watchdog: Optional[bool] = None,
                         **kwargs) -> GuardedPlan:
    """Build a :class:`GuardedPlan`: ``stencil_plan`` arguments plus
    ``watchdog`` (None = the ``REPRO_NAN_WATCHDOG`` env flag).

    Raw argument errors (bad ``t``, rank mismatch, unknown backend, no
    card for ``device=None``) raise immediately and unguarded -- the
    ladder only absorbs *kernel* failures, never caller bugs.

    ``batch=B`` plans are guarded per batch, as in JAX: a failing rung
    demotes the whole bucket, the next rung re-runs the whole batched
    input, and the watchdog checks (and re-runs) the whole batch.
    ``batch`` and ``batch_mode`` ride through every rung; only the tile
    pins drop on the degraded rung."""
    _plan.plan_signature(spec_or_weights, grid_shape, dtype, t,
                         **{k: v for k, v in kwargs.items()
                            if k != "use_cache"})
    return GuardedPlan((spec_or_weights, tuple(int(n) for n in grid_shape),
                        dtype, t), kwargs, watchdog=watchdog)
