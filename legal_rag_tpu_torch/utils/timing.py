"""Per-stage timing — the observability the reference lacks (it logs
only whole-request wall clock, reference app.py:116,143-144). Each
pipeline stage (encode / postings / device_search / classify / ...)
accumulates call counts and latencies; snapshots feed /health metrics
and the bench harness. ``torch.profiler`` traces can wrap any stage via
the same context manager."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict


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
            dt = time.perf_counter() - start
            with self._lock:
                self._totals[name] += dt
                self._counts[name] += 1
                self._last[name] = dt

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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace for everything in the scope (host
    and, where the build has it, CUDA activity), written to ``log_dir``
    as a Chrome trace — the profiling hook SURVEY.md §5.1 calls for (the
    reference only logs whole-request wall clock)."""
    import torch.profiler

    acts = torch.profiler.supported_activities()
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield
