"""Test-support utilities shipped with the library (fault injection), the
counterpart of ``repro.testing``: the guard's fault hooks import it
unconditionally, so it lives in the package, not under ``tests/``."""
from .faults import (  # noqa: F401
    FaultSpec,
    active_faults,
    corrupt_geometry,
    corrupt_output,
    fault_hits,
    first_call,
    inject,
    maybe_fail,
    on_launch,
    parse_faults,
    reset_faults,
    traced,
)

__all__ = [
    "FaultSpec",
    "active_faults",
    "corrupt_geometry",
    "corrupt_output",
    "fault_hits",
    "first_call",
    "inject",
    "maybe_fail",
    "on_launch",
    "parse_faults",
    "reset_faults",
    "traced",
]
