"""Where the host time of one kernel launch goes: P's wrapper, step by step.

``row_argmax`` (kernel P, :mod:`legal_rag_tpu_torch.ops.argmax_probe`)
reduces an ``[8, 256]`` float32 input; its device work is a few
microseconds, so a run of back-to-back calls measures the host path
that every wrapper of the port shares. Each step below is timed alone
by ``time.perf_counter_ns`` over ``iters`` calls (ns a call):

- ``call``: the whole ``row_argmax`` call;
- ``checks``: the wrapper's input checks;
- ``empty`` / ``new_empty``: the ``[8]`` int32 output by
  ``torch.empty(..., device=x.device)`` and by ``x.new_empty``;
- ``library``: ``P.library()`` once the library is loaded;
- ``stream_public`` / ``stream_raw``: the current stream's handle by
  ``torch.cuda.current_stream(device).cuda_stream`` and by
  ``torch._C._cuda_getCurrentRawStream(index)``;
- ``data_ptr``: the two ``data_ptr()`` reads;
- ``device_index`` / ``get_device``: ``x.device.index`` and
  ``x.get_device()``;
- ``ctypes_floor``: the entry point called with ``n_rows = 0``, which it
  rejects before any CUDA call (the binding's own cost);
- ``launch``: the entry point with real arguments (the ctypes call, the
  device check and the kernel launch);
- ``count``: ``P.count_launch()``;
- ``torch_argmax``: ``torch.argmax(x, dim=1)``, one PyTorch call that
  computes the same function.

Beside them, ``events_ms`` is the smoke's CUDA-event time of the call
(``utils.timing.time_ms``: 20 back-to-back calls), and ``device_us`` the
kernel's own time from ``torch.profiler`` (CUDA activity), or None where
the profiler records no device time.

Run on the card:  python -m legal_rag_tpu_torch.scripts.launch_steps
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

import torch

from legal_rag_tpu_torch.ops.argmax_probe import (
    P, probe_input, row_argmax,
)
from legal_rag_tpu_torch.utils.timing import time_ms

ITERS = 10_000
_BATCH = 1_000        # calls between synchronisations (outside the clock)


def _ns_per_call(fn: Callable[[], object], iters: int) -> float:
    """Mean host ns of ``fn`` over ``iters`` calls, timed in batches of
    ``_BATCH`` with a synchronise between batches (not timed), so the
    launch queue never fills."""
    for _ in range(min(iters, 100)):
        fn()
    torch.cuda.synchronize()
    total, done = 0, 0
    while done < iters:
        n = min(_BATCH, iters - done)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        done += n
    return total / iters


def _checks(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError("not a CUDA tensor")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("bad input")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError("empty input")


def device_us(x: torch.Tensor, calls: int = 200) -> Optional[float]:
    """P's mean device time in us over ``calls`` launches, from
    torch.profiler's CUDA activity; None if it records none."""
    from torch.profiler import ProfilerActivity, profile

    row_argmax(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            row_argmax(x)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "argmax_rows_kernel" in ev.key:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            return total / ev.count if ev.count and total else None
    return None


def run(iters: int = ITERS) -> Dict[str, Optional[float]]:
    """Every step's host ns a call, the CUDA-event ms of the call and
    the kernel's device us (module doc). Needs a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch_steps needs a CUDA card")
    x = probe_input("cuda")
    idx = x.device.index or 0
    lib = P.library()
    out = torch.empty(8, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xp, op = x.data_ptr(), out.data_ptr()
    steps = {
        "call": lambda: row_argmax(x),
        "checks": lambda: _checks(x),
        "empty": lambda: torch.empty(8, dtype=torch.int32, device=x.device),
        "new_empty": lambda: x.new_empty((8,), dtype=torch.int32),
        "library": P.library,
        "stream_public": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "data_ptr": lambda: (x.data_ptr(), out.data_ptr()),
        "device_index": lambda: x.device.index,
        "get_device": x.get_device,
        "ctypes_floor": lambda: lib.argmax_probe_launch(xp, 0, 256, op, idx,
                                                        stream),
        "launch": lambda: lib.argmax_probe_launch(xp, 8, 256, op, idx, stream),
        "count": P.count_launch,
        "torch_argmax": lambda: torch.argmax(x, dim=1),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        steps["stream_raw"] = lambda: raw(idx)
    res: Dict[str, Optional[float]] = {
        name: _ns_per_call(fn, iters) for name, fn in steps.items()
    }
    res["events_ms"] = time_ms(lambda: row_argmax(x))
    res["torch_argmax_events_ms"] = time_ms(lambda: torch.argmax(x, dim=1))
    res["device_us"] = device_us(x)
    return res


def main() -> None:
    print(json.dumps({"launch_steps": run(),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
