"""Timing and tracing (port of ``pddp_tpu/utils/profiling.py``).

 * ``PhaseTimer``: named wall-clock phases, each closed by a device
   synchronize, so that a phase owns the device work it enqueued;
 * ``block_and_time``: the wall time of a call with its device work;
 * ``trace``: ``torch.profiler`` over a block, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer", "trace", "block_and_time"]


def _synchronize():
    """Waits for the card's queued work (nothing to wait for where CUDA
    was never used)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def block_and_time(fn, *args, n=1, warmup=0, **kwargs):
    """Seconds per call of ``fn(*args, **kwargs)`` over ``n`` calls after
    ``warmup`` calls, the device synchronized around the timed calls.

    Returns:
        (seconds_per_call, last output).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kwargs)
    _synchronize()
    return (time.perf_counter() - t0) / n, out


class PhaseTimer:
    """Accumulating named phase timer.

    Usage::

        timer = PhaseTimer()
        with timer("forward"):
            derivs = forward(...)
        with timer("backward"):
            k, K, ok = backward(...)
        print(timer.summary())

    Each phase synchronizes the device when it closes, so the numbers are
    wall clock per phase, device work included.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        """Formatted per-phase totals (ms) sorted by cost."""
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            "{:<24s} {:>10.3f} ms  (x{})".format(
                name, total * 1e3, self.counts[name])
            for name, total in rows)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (the host, and the card where
    there is one), written to ``log_dir/trace.json`` as a Chrome trace
    (open it in Perfetto or chrome://tracing).

    Usage::

        with profiling.trace("build/trace"):
            result = solve(...)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
