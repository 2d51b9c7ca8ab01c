"""Shared environment-variable parsing for the runtime's tuning knobs.

A copy of ``repro.core.envutil``; the port reads REPRO_PLAN_CACHE_SIZE,
REPRO_VMEM_BUDGET (its tile rule's shared-memory budget), REPRO_FAULTS,
REPRO_NAN_WATCHDOG and REPRO_COUNT_LOADS (the foils' load-counting
build).

Every ``REPRO_*`` knob (``REPRO_VMEM_BUDGET``, ``REPRO_PLAN_CACHE_SIZE``,
``REPRO_FAULTS``, ``REPRO_BENCH_BUDGET_S``, ``REPRO_NAN_WATCHDOG``, the
``REPRO_SERVE_*`` family, ...) parses through these helpers, so a
malformed value always produces the same style of actionable message --
naming the variable, the offending value, and the accepted form --
instead of a raw ``ValueError`` from ``int()`` deep inside a
kernel-sizing path.  Values are re-read on every call (no import-time
caching): tests and long-running servers retune without reimporting,
matching the historical behavior of ``vmem_budget_bytes`` /
``plan_cache_max``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw value of ``name``; empty/whitespace-only counts as unset
    (an empty export is a shell accident, never a meaningful knob)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip()


#: (name, raw, minimum) -> parsed value.  The ENVIRONMENT is still read
#: on every call (retune-without-reimport stays intact); only the
#: parse+validate of an already-seen raw string is skipped -- knobs like
#: REPRO_VMEM_BUDGET sit on the per-request plan-signature path.
_INT_PARSE_CACHE: dict = {}


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Integer knob ``name``: the parsed value if set, else ``default``.

    Raises ``ValueError`` with the variable name and offending text on
    garbage (``"zero"``, ``"8MB"``), and on values below ``minimum``
    (negative cache bounds / budgets are always configuration errors, not
    requests for "unbounded").
    """
    raw = env_str(name)
    if raw is None:
        return default
    key = (name, raw, minimum)
    value = _INT_PARSE_CACHE.get(key)
    if value is not None:
        return value
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, got {raw!r}") from None
    if value < minimum:
        raise ValueError(
            f"{name} must be >= {minimum}, got {value}")
    _INT_PARSE_CACHE[key] = value
    return value


def env_int_list(name: str, default: Sequence[int],
                 minimum: int = 1) -> Tuple[int, ...]:
    """Comma-separated integer-list knob (e.g. ``REPRO_SERVE_BUCKETS``):
    the parsed tuple if set, else ``tuple(default)``.

    Empty/whitespace-only values count as unset (matching :func:`env_str`);
    empty items between commas (``"1,,4"``, trailing commas) are ignored.
    Garbage items and values below ``minimum`` raise ``ValueError`` naming
    the variable and the offending item -- a malformed bucket ladder must
    fail loudly, never silently serve unbatched.
    """
    raw = env_str(name)
    if raw is None:
        return tuple(default)
    out = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            value = int(item)
        except ValueError:
            raise ValueError(
                f"{name} must be a comma-separated list of integers, "
                f"got {item!r} in {raw!r}") from None
        if value < minimum:
            raise ValueError(
                f"{name} entries must be >= {minimum}, got {value}")
        out.append(value)
    if not out:
        return tuple(default)
    return tuple(out)


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: ``1/true/yes/on`` enable, ``0/false/no/off`` disable
    (case-insensitive); anything else is a configuration error."""
    raw = env_str(name)
    if raw is None:
        return default
    low = raw.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"{name} must be a boolean (1/0/true/false/yes/no/on/off), "
        f"got {raw!r}")
