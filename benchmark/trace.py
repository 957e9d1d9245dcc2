"""The device trace of a stretch of the window, and what is read from it.

``torch.profiler`` records the host and the card over the stretch; the
trace is exported as Chrome JSON into the run's temporary directory,
read back and deleted. From it:

- the device's busy intervals (kernels, copies and sets, merged), so
  ``busy_s`` is the time in which any operation ran on the card;
- each kernel's time by name, and which host span (``StageTimer``'s
  ``record_function`` ranges, named when ``LEGAL_RAG_PROFILE`` is set)
  launched it, found through the launch's correlation id;
- the idle gaps between busy intervals, each named by the host span
  that covers its middle (none: orchestration, the cross-encoder or the
  responder, which have no span yet).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("encode", "postings", "device_search", "int8_rescore")
NAME_CHARS = 120    # a kernel's name in the breakdown, cut (templates run long)


class Tracer:
    """One profiler run over a stretch of the window. Made during
    set-up, where a throwaway run first loads and starts the card's
    tracing library (seconds, the first time in a process), so that the
    start inside the window is short; ``overhead_s`` is the time spent
    inside the window starting and stopping."""

    def __init__(self):
        import torch
        import torch.profiler

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.started = self.stopped = False
        self.t_start = self.t_stop = None
        self.overhead_s = 0.0

    def start(self) -> None:
        import time

        if not self.started:
            t0 = time.perf_counter()
            self.prof.start()
            self.started = True
            self.t_start = time.perf_counter()
            self.overhead_s += self.t_start - t0

    def stop(self) -> None:
        import time

        import torch

        if self.started and not self.stopped:
            torch.cuda.synchronize()
            self.t_stop = time.perf_counter()
            self.prof.stop()
            self.stopped = True
            self.overhead_s += time.perf_counter() - self.t_stop

    def read(self) -> Optional["TraceReading"]:
        if not self.stopped:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return TraceReading(events, self.t_stop - self.t_start)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceReading:
    """Times in microseconds inside, seconds outside."""

    def __init__(self, events: List[Dict], stretch_s: float):
        self.stretch_s = stretch_s
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.device_ops = dev
        self.busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") in SPANS]
        self.spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                             e.get("tid")) for e in spans)
        self._starts = [s[0] for s in self.spans]
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e["ts"], e.get("tid"))
        self.kernel_span: Dict[str, float] = defaultdict(float)
        for e in dev:
            if e.get("cat") != "kernel":
                continue
            corr = e.get("args", {}).get("correlation")
            at = launches.get(corr)
            name = self.span_at(at[0], at[1]) if at else None
            self.kernel_span[name or "none"] += e["dur"] * 1e-6

    def span_at(self, ts: float, tid=None, look_back: int = 64
                ) -> Optional[str]:
        """The innermost span open at ``ts`` (on thread ``tid``, if
        given); spans are short, so only the last ``look_back`` that
        opened before ``ts`` are looked at."""
        i = bisect.bisect_right(self._starts, ts)
        for a, b, name, t in reversed(self.spans[max(0, i - look_back):i]):
            if ts <= b and (tid is None or t == tid):
                return name
        return None

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for e in self.device_ops:
            by[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds between busy intervals, summed by the host span
        under each gap's middle, largest first."""
        by: Dict[str, float] = defaultdict(float)
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            name = self.span_at(0.5 * (a + b)) or "none"
            by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
