"""The end-to-end statistics, over all the work and all the time of the
window."""

from __future__ import annotations

import numpy as np


def solves_per_s(lanes: int, ticks: int, segments: int,
                 window_s: float) -> float:
    """Every lane-tick of every whole segment the window ran, over the
    window's time (which ends with the last segment)."""
    return lanes * ticks * segments / window_s


def latency_ms(latencies_s) -> dict:
    """The median and the 95th percentile (linear interpolation) of every
    request's latency, in ms."""
    ms = np.asarray(latencies_s, np.float64) * 1e3
    return {"request_ms_p50": float(np.percentile(ms, 50)),
            "request_ms_p95": float(np.percentile(ms, 95))}
