"""Shared measurement plumbing for the port's benchmarks (the counterpart
of ``benchmarks/timing.py``).

Every device time a benchmark emits comes from :func:`time_us`: it warms
the call up (building its kernels outside the timed region) and times the
calls with CUDA events, so the numbers are device time, not host enqueue
time.  It needs a card: a CPU run has no device time to report.

``case_budget`` bounds one case's wall clock: a pathological build (the
failure mode the guard layer exists for) raises :class:`CaseTimeout`
instead of wedging a benchmark run forever.
"""
from __future__ import annotations

import signal
import threading
from contextlib import contextmanager

import torch

from repro_torch.core.envutil import env_int

#: Default per-case wall-clock budget (seconds); override with
#: REPRO_BENCH_BUDGET_S.  0 disables the budget entirely.
BENCH_BUDGET_S = 300


class CaseTimeout(RuntimeError):
    """One benchmark case exceeded its wall-clock budget."""


def bench_budget_s() -> int:
    return env_int("REPRO_BENCH_BUDGET_S", BENCH_BUDGET_S, minimum=0)


@contextmanager
def case_budget(seconds: int = None):
    """Raise :class:`CaseTimeout` if the block runs longer than the budget.

    SIGALRM-based, so it interrupts a wedged build mid-flight.  A no-op
    when the budget is 0, off the main thread (signals unavailable), or
    when an outer alarm is already pending (nested budgets must not cancel
    the enclosing deadline).
    """
    if seconds is None:
        seconds = bench_budget_s()
    usable = (seconds > 0
              and threading.current_thread() is threading.main_thread()
              and signal.getitimer(signal.ITIMER_REAL)[0] == 0)
    if not usable:
        yield
        return

    def on_alarm(signum, frame):
        raise CaseTimeout(f"benchmark case exceeded {seconds}s budget")

    prior = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prior)


def time_us(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Mean device microseconds per call of ``fn(*args)`` on the card, from
    CUDA events around ``iters`` calls after ``warmup`` calls.  Raises
    when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_us measures device time and needs a CUDA "
                           "device; a CPU run has none to report")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters
