"""Wall-clock timing of jitted device work.

Warm up, then time each call on the host clock around work that ends in
``jax.block_until_ready``, and report the median, percentiles and the
sample count.  Nothing is discarded: a short sample is as valid as a long
one.
"""

from __future__ import annotations

import time

import jax
import numpy as np

__all__ = ["time_fn"]


def time_fn(fn, *args, warmup: int = 3, samples: int = 30) -> dict:
    """Seconds per call of ``fn(*args)``, waiting for the device each call.

    Returns ``{"median", "p10", "p90", "min", "max", "n"}``.  ``fn`` should
    be jitted, so that the first (warm-up) call compiles and the samples
    time only execution."""
    if samples < 1:
        raise ValueError(f"samples must be >= 1, got {samples}")
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t = np.empty(samples)
    for i in range(samples):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        t[i] = time.perf_counter() - t0
    return {
        "median": float(np.median(t)),
        "p10": float(np.percentile(t, 10)),
        "p90": float(np.percentile(t, 90)),
        "min": float(t.min()),
        "max": float(t.max()),
        "n": int(samples),
    }
