"""Deterministic fault injection for the guarded execution layer (the
counterpart of ``repro.testing.faults``: the same kinds, the same
``REPRO_FAULTS`` grammar, the same ``inject()``).

Every failure class the degradation ladder must survive has a kind:

- ``compile``: raise the failure ``kernels/_build.py`` raises when
  ``nvcc`` cannot build a kernel, where a plan first reaches a kernel
  (:func:`on_launch`);
- ``vmem``: raise CUDA's launch refusal for a block that asks for more
  shared memory or registers than the SM has ("too many resources
  requested for launch") at the same point, as if the tile estimate lied;
- ``nan``: corrupt a guarded step's output with NaN (consumed by
  ``GuardedPlan`` via :func:`corrupt_output`) to exercise the watchdog;
- ``geometry``: corrupt the static auditor's walk of the next audited
  launch (:func:`corrupt_geometry`: a window read twice), never a launch
  on the card -- the port's kernels compute their windows on the device,
  so the fault warps what the auditor enumerates, as JAX's
  ``corrupt_geometry`` warps the BlockSpec index maps it walks;
- ``halo``: raise a failed halo exchange where the distributed stepper
  (``repro_torch.stencil.distributed``) starts an exchange round, in
  ``_extend`` and ``_overlap_step``, before any send or receive is
  posted, as JAX's ``maybe_fail("halo")`` does there; every rank of a
  world fires on the same round, so none is left waiting on a peer.

The JAX package fires ``compile`` and ``vmem`` once per kernel launch
while a plan's runner is traced, which happens on the plan's first call.
The port has no tracing, so :func:`on_launch` fires them once per kernel
launch during a plan's first call (:func:`first_call`, opened by
``StencilPlan.__call__``): the same spec lands both packages on the same
rung.  The seed 9-tile foils and the reference oracle have no hook in
either package.

Faults come from two sources, checked in order:

1. the :func:`inject` context manager (tests -- scoped, nestable), and
2. the ``REPRO_FAULTS`` env var, a comma list of ``kind[:times[@skip]]``
   terms: ``compile`` fires once; ``compile:3`` fires three times;
   ``vmem:1@2`` skips two hits then fires once; ``compile:inf`` fires
   forever.

Both are process-local and deterministic.  When no fault is configured
every hook is a few-nanosecond no-op.
"""
from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from repro_torch.core.envutil import env_str

ENV_VAR = "REPRO_FAULTS"

KINDS = ("compile", "vmem", "nan", "halo", "geometry")

# Messages mimic the port's own failures so ``classify_failure`` in
# repro_torch.kernels.guard takes the path real errors take; "(injected)"
# marks them in logs and event dumps.  {kernel} is the kernel's source.
_MESSAGES = {
    "compile": "nvcc failed to build {kernel}.cu (exit 1): (injected)",
    "vmem": ("{kernel} launch failed: CUDA error 701 (too many resources "
             "requested for launch) (injected)"),
    "halo": "injected fault: halo exchange failed",
}


@dataclass
class FaultSpec:
    """One armed fault: fire ``times`` times after ``skip`` initial hits."""

    kind: str
    times: float = 1  # math.inf for "always"
    skip: int = 0
    fired: int = field(default=0, compare=False)
    hits: int = field(default=0, compare=False)

    def should_fire(self) -> bool:
        self.hits += 1
        if self.hits <= self.skip:
            return False
        if self.fired >= self.times:
            return False
        self.fired += 1
        return True


def parse_faults(raw: str) -> List[FaultSpec]:
    """Parse a ``REPRO_FAULTS`` value; raises ValueError on malformed
    terms so a typo'd spec fails loudly, not silently clean."""
    specs: List[FaultSpec] = []
    for term in raw.split(","):
        term = term.strip()
        if not term:
            continue
        kind, times, skip = term, 1.0, 0
        if ":" in term:
            kind, _, rest = term.partition(":")
            times_s, _, skip_s = rest.partition("@")
            try:
                times = math.inf if times_s.strip() == "inf" \
                    else float(int(times_s))
                skip = int(skip_s) if skip_s else 0
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR}: malformed term {term!r}; expected "
                    f"kind[:times[@skip]] with integer or 'inf' times"
                ) from None
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"{ENV_VAR}: unknown fault kind {kind!r}; "
                f"expected one of {', '.join(KINDS)}")
        if times < 1 or skip < 0:
            raise ValueError(
                f"{ENV_VAR}: malformed term {term!r}; "
                f"times must be >= 1 and skip >= 0")
        specs.append(FaultSpec(kind, times, skip))
    return specs


# Active-fault state: an explicit stack from inject() layered over the
# env-derived specs, re-parsed only when the raw string changes, so the
# counters persist across hooks within one configuration.
_STACK: List[List[FaultSpec]] = []
_ENV_RAW: Optional[str] = None
_ENV_SPECS: List[FaultSpec] = []


def _env_specs() -> List[FaultSpec]:
    global _ENV_RAW, _ENV_SPECS
    raw = env_str(ENV_VAR)
    if raw != _ENV_RAW:
        _ENV_RAW = raw
        _ENV_SPECS = parse_faults(raw) if raw else []
    return _ENV_SPECS


def active_faults() -> List[FaultSpec]:
    """All armed specs, innermost inject() scope first, env last."""
    out: List[FaultSpec] = []
    for layer in reversed(_STACK):
        out.extend(layer)
    out.extend(_env_specs())
    return out


def reset_faults() -> None:
    """Drop all injected scopes and force env re-parse (test hygiene)."""
    global _ENV_RAW, _ENV_SPECS
    _STACK.clear()
    _ENV_RAW = None
    _ENV_SPECS = []


def fault_hits() -> Dict[str, int]:
    """How many times each kind actually fired (for assertions)."""
    counts: Dict[str, int] = {}
    for spec in active_faults():
        counts[spec.kind] = counts.get(spec.kind, 0) + spec.fired
    return counts


@contextmanager
def inject(kind: str, times: float = 1, skip: int = 0) -> Iterator[FaultSpec]:
    """Arm one fault for the dynamic extent of the block; yields the spec
    so tests can assert ``spec.fired`` afterwards."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"expected one of {', '.join(KINDS)}")
    spec = FaultSpec(kind, times, skip)
    layer = [spec]
    _STACK.append(layer)
    try:
        yield spec
    finally:
        _STACK.remove(layer)


# --------------------------------------------------------------------------
# Hooks called from production code.
# --------------------------------------------------------------------------
def _armed() -> bool:
    return bool(_STACK) or ENV_VAR in os.environ


def maybe_fail(kind: str, kernel: str = "stencil") -> None:
    """Raise the configured failure for ``kind`` if a matching fault is
    armed and due (``kernel`` names the kernel in the message).  No-op
    (beyond one env read) when nothing is armed."""
    if not _armed():
        return
    for spec in active_faults():
        if spec.kind == kind and spec.should_fire():
            raise RuntimeError(_MESSAGES.get(kind, f"injected fault: {kind}")
                               .format(kernel=kernel))


_FIRST = threading.local()


@contextmanager
def first_call() -> Iterator[None]:
    """The scope of a plan's first call, in which :func:`on_launch` fires
    (per thread, so plans built and called on other threads are apart)."""
    _FIRST.depth = getattr(_FIRST, "depth", 0) + 1
    try:
        yield
    finally:
        _FIRST.depth -= 1


@contextmanager
def traced() -> Iterator[None]:
    """The rest of a plan's first call once its runner has been through
    its kernels once: a "map" plan's later grids, which JAX runs from the
    runner it traced once.  :func:`on_launch` stays quiet inside."""
    depth = getattr(_FIRST, "depth", 0)
    _FIRST.depth = 0
    try:
        yield
    finally:
        _FIRST.depth = depth


def on_launch(kernel: str) -> None:
    """The kernel hook: inside a plan's first call, the ``compile`` and
    then the ``vmem`` fault each get one hit per kernel launch, as in the
    JAX package's substrate launchers.  ``kernel`` is the source the
    launch builds from, for the message."""
    if getattr(_FIRST, "depth", 0) and _armed():
        maybe_fail("compile", kernel)
        maybe_fail("vmem", kernel)


def corrupt_geometry(walk):
    """If a ``geometry`` fault is due, return the auditor's window walk
    (``repro_torch.audit.blocks.Walk``) with a window read twice
    (``Walk.repeat_window``); otherwise ``walk``.  Called only from the
    auditor, once per audited launch."""
    if not _armed():
        return walk
    for spec in active_faults():
        if spec.kind == "geometry" and spec.should_fire():
            return walk.repeat_window()
    return walk


def corrupt_output(y):
    """If a ``nan`` fault is due, return a copy of ``y`` (the guarded
    step's output) with its first element NaN; otherwise ``y``.  Called
    only from the guard layer, never from kernels."""
    if not _armed():
        return y
    for spec in active_faults():
        if spec.kind == "nan" and spec.should_fire():
            y = y.clone()
            y.view(-1)[0] = float("nan")
            return y
    return y
