"""Bounded, process-wide event log for guarded execution (a copy of
``repro.core.events``).

The guard layer (``repro_torch.kernels.guard``) records every classified
failure and every degradation-ladder move here.  The log is a fixed-size
ring buffer: a pathological failure loop can never grow memory without
bound, and dropped events are counted so the benchmark dump still shows
that truncation happened.  A clean run records nothing -- the guard
layer must be invisible until something actually fails.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

_CAPACITY = 256


class EventLog:
    """Thread-safe ring buffer of structured events."""

    def __init__(self, capacity: int = _CAPACITY):
        self._capacity = int(capacity)
        if self._capacity < 1:
            raise ValueError(
                f"EventLog capacity must be >= 1, got {capacity}")
        self._buf: deque = deque(maxlen=self._capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Append an event; returns the stored dict (already sequenced)."""
        with self._lock:
            event = {"seq": self._seq, "kind": str(kind)}
            event.update(fields)
            self._seq += 1
            if len(self._buf) == self._capacity:
                self._dropped += 1
            self._buf.append(event)
            return event

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._buf)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq = 0
            self._dropped = 0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view: events plus loss accounting."""
        with self._lock:
            return {
                "capacity": self._capacity,
                "recorded": self._seq,
                "dropped": self._dropped,
                "events": list(self._buf),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# The process-wide log all guard paths share.  Module-level functions are
# the public API so callers never hold a reference to a stale instance
# across a clear().
EVENTS = EventLog()


def record(kind: str, **fields: Any) -> Dict[str, Any]:
    return EVENTS.record(kind, **fields)


def events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    return EVENTS.events(kind)


def clear() -> None:
    EVENTS.clear()


def snapshot() -> Dict[str, Any]:
    return EVENTS.snapshot()
