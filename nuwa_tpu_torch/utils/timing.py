"""Seconds per step with the cost of one synchronisation cancelled.

Counterpart of ``nuwa_tpu/utils/timing.py``. Timing ``dispatch -> sync``
once per step charges each step the fixed cost of a synchronisation (the
host's read-back and the launch queue's drain). Launches queue on the card,
so the two-point form cancels that constant: time k_hi and k_lo chained
dispatches, one sync each, and divide the difference.

    from nuwa_tpu_torch.utils.timing import device_rate
    seconds = device_rate(lambda: model(x))  # one step's device seconds
"""
from __future__ import annotations

import time
import warnings

import torch


def sync(x) -> float:
    """Force completion: reduce ``x`` to a scalar and read it back."""
    return float(torch.as_tensor(x).float().sum())


def device_rate(dispatch, k_lo: int = 2, k_hi: int = 10, reps: int = 2):
    """Seconds per dispatch with the sync round trip cancelled.

    ``dispatch()`` must queue ONE step and return a tensor to sync on (chain
    state through a closure for stateful steps so the k dispatches really
    run back to back). When k_hi runs were not slower than k_lo (jitter
    swamped the signal) it measures once more, then warns and returns the
    amortised upper bound hi / k_hi."""

    def run(k):
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = dispatch()
        sync(out)
        return time.perf_counter() - t0

    run(1)  # warm
    lo = min(run(k_lo) for _ in range(reps))
    hi = min(run(k_hi) for _ in range(reps))
    if hi <= lo:  # jitter swamped the signal: retry once
        lo = min(lo, min(run(k_lo) for _ in range(reps)))
        hi = min(hi, min(run(k_hi) for _ in range(reps)))
    if hi <= lo:
        warnings.warn(
            "device_rate: k_hi run was not slower than k_lo (jitter); "
            "falling back to the amortized upper bound hi/k_hi",
            stacklevel=2,
        )
        return hi / k_hi
    return (hi - lo) / (k_hi - k_lo)
