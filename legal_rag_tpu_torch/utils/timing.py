"""Per-stage timing — the observability the reference lacks (it logs
only whole-request wall clock, reference app.py:116,143-144). Each
pipeline stage (encode / postings / device_search / classify / ...)
accumulates call counts and latencies; snapshots feed /health metrics
and the bench harness. ``torch.profiler`` traces can wrap any stage via
the same context manager."""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict


class StageTimer:
    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._last: Dict[str, float] = {}
        # the server handles queries on a thread pool; accumulation is
        # read-modify-write and must not lose updates under concurrency
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a pipeline stage. When LEGAL_RAG_PROFILE is set, the
        stage also emits a torch.profiler record_function so device-side
        work shows up named in TensorBoard/Chrome traces."""
        if os.environ.get("LEGAL_RAG_PROFILE"):
            import torch.profiler

            ctx = torch.profiler.record_function(name)
        else:
            ctx = contextlib.nullcontext()
        start = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        """Record ``seconds`` under ``name`` as one call of that stage:
        the path of every stage, and of an interval that is no ``with``
        block on one thread (a queue wait from one thread's submit to
        another's dispatch). Called directly it emits no profiler
        range: only :meth:`stage` does."""
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1
            self._last[name] = seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": self._counts[name],
                    "total_s": self._totals[name],
                    "mean_ms": 1e3 * self._totals[name]
                    / max(self._counts[name], 1),
                    "last_ms": 1e3 * self._last.get(name, 0.0),
                }
                for name in self._totals
            }

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()
            self._last.clear()


def timed(name: str):
    """Decorator: each call of the method is the stage ``name`` on its
    object's ``timer``."""
    def wrap(method):
        @functools.wraps(method)
        def timed_method(self, *args, **kwargs):
            with self.timer.stage(name):
                return method(self, *args, **kwargs)
        return timed_method
    return wrap


def time_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``,
    by CUDA events on the current stream (the card's clock, not the
    host's: launches return before the device finishes)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
