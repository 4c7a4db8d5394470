"""Performance measurement tools.

Covers the roles of the reference's ``PerformanceLog``/``log_summary``
(reference src/auxilliary/logging.py) and ``Averager``
(reference src/auxilliary/utils.py:11-46), implemented independently:
timers are host-side wall clocks; callers must block on device results inside
the timed region (the solve loops synchronise on the jitted step's outputs)
so async dispatch does not leak out of the measurement — the analogue of
the reference's synchronous PETSc solves.
"""

import sys
import time
from collections import defaultdict
from contextlib import ContextDecorator

import numpy as np

__all__ = ["PerformanceLog", "log_summary", "Averager", "progress"]


class PerformanceLog(ContextDecorator):
    """Context manager / decorator accumulating wall-clock per label.

    Samples are stored process-wide so nested solver layers can report into
    one table, mirroring the observability the reference builds its per-label
    timing on.
    """

    data = defaultdict(list)

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        PerformanceLog.data[self.label].append(time.perf_counter() - self._t0)

    @classmethod
    def reset(cls):
        cls.data = defaultdict(list)


def log_summary(out=print):
    """Print per-label call counts and wall-clock statistics.

    Labels are sorted by total time, descending; emits nothing when no timer
    ran.  ``out`` is injectable for testing.
    """
    if not PerformanceLog.data:
        return
    rows = []
    for label, samples in PerformanceLog.data.items():
        t = np.asarray(samples)
        rows.append((label, t.size, float(t.sum()), float(t.mean()), float(t.std())))
    rows.sort(key=lambda r: r[2], reverse=True)

    width = max(len(r[0]) for r in rows)
    header = f"{'timer':<{width}s}  {'calls':>7s}  {'total[s]':>11s}  {'mean[s]':>11s}  {'std[s]':>11s}"
    out(header)
    out("=" * len(header))
    for label, ncall, total, avg, std in rows:
        out(f"{label:<{width}s}  {ncall:7d}  {total:11.4e}  {avg:11.4e}  {std:11.4e}")


class Averager:
    """Streaming mean of solver iteration counts (reference utils.py:11-46
    role; Welford-style single-pass update)."""

    def __init__(self):
        self.reset()

    @property
    def value(self):
        return self._mean

    @property
    def n_samples(self):
        return self._count

    @property
    def min(self):
        """Smallest sample seen (None before the first)."""
        return self._min

    def update(self, x):
        self._count += 1
        self._mean += (x - self._mean) / self._count
        self._min = x if self._min is None else min(self._min, x)

    def reset(self):
        self._count = 0
        self._mean = 0.0
        self._min = None

    def __repr__(self):
        return f"{self.value} (averaged over {self.n_samples} samples)"


def progress(steps, out=None):
    """Iterate over ``steps`` (a ``range`` of timestep indices), rewriting
    one "step k/n [elapsed]" progress line on ``out`` (stderr) after each."""
    out = sys.stderr if out is None else out
    t0 = time.perf_counter()
    for k in steps:
        yield k
        elapsed = time.perf_counter() - t0
        print(f"\rstep {k + 1}/{steps.stop} [{elapsed:.1f}s]", end="", file=out,
              flush=True)
    if len(steps):
        print(file=out, flush=True)
