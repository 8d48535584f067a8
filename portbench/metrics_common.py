"""Readings that several per-layer metrics share."""
from __future__ import annotations


def idle_share(trace):
    """Share of the traced window with no kernel, copy or memset on the
    card (%); nothing without a trace or a device operation in it."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)

