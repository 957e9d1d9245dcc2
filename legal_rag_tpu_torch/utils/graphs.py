"""Captured device programs: the port's counterpart of the JAX package's
per-bucket ``jit``.

The JAX package runs each served device program (the hybrid search, the
query encoder's MiniLM forward, the cross-encoder's) as one compiled
executable per key, the key being the input shapes and the static
arguments: every batch in a bucket reuses it. On the card the
counterpart of an executable is a CUDA graph. :class:`GraphSet` holds an
engine's graphs, one per key, captured on the key's first use as
``jit`` compiles on its first call:

- the static inputs live outside the graphs' memory pool, one set a
  shape (programs of the same input shapes share them), and every call
  fills them whole from pinned host staging, padded rows included;
- the first call runs the program once eagerly on a side stream (it
  builds the kernels' libraries and sets their attributes), then
  captures it into the one memory pool that all the set's graphs share;
- a call fills the inputs, replays the graph and copies its outputs to
  the host under one lock, so no graph replays before the last one's
  outputs are read: the pool may hand one graph's outputs the memory
  that another keeps its intermediates in.

A capture that fails raises: nothing falls back to eager on the card.
CPU tensors have no graphs and run eagerly (:func:`run_program`), as a
kernel's wrapper runs its plain version there.

Kernel launches inside a capture are recorded, not made: the program
takes them back from the wrappers' counters and adds them to each
kernel's ``in_replays`` at every replay (``utils/cuda_build.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.utils.cuda_build import KERNELS, CudaKernel
from legal_rag_tpu_torch.utils.timing import StageTimer

Inputs = Dict[str, np.ndarray]
Program = Callable[..., Tuple[torch.Tensor, ...]]


def _counts() -> Dict[CudaKernel, Dict[str, int]]:
    return {k: k.counts() for k in KERNELS}


@contextlib.contextmanager
def _syncs_raise(on: bool):
    """Within, a host sync on the card raises (``set_sync_debug_mode``,
    which is process-wide: for single-threaded checks)."""
    if not on:
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def to_host(outputs: Tuple[torch.Tensor, ...]) -> Tuple[np.ndarray, ...]:
    return tuple(t.cpu().numpy() for t in outputs)


def run_eager(fn: Program, inputs: Inputs,
              device: torch.device) -> Tuple[np.ndarray, ...]:
    """``fn`` on the inputs uploaded to ``device``, op by op."""
    return to_host(fn(**{
        name: torch.from_numpy(np.asarray(a, order="C")).to(device)
        for name, a in inputs.items()}))


class CapturedProgram:
    """One key's graph: its static inputs, its outputs, the kernel
    launches its capture recorded and its replays."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 inputs: Dict[str, torch.Tensor],
                 outputs: Tuple[torch.Tensor, ...],
                 launches: Dict[CudaKernel, Dict[str, int]],
                 capture_s: float) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for kernel, delta in self.launches.items():
            kernel.count_replays(delta)


class GraphSet:
    """An engine's captured programs on one card: one memory pool, one
    lock. ``enabled`` False runs every program eagerly (to compare the
    two); ``check_syncs`` runs each warm-up under
    ``set_sync_debug_mode("error")``, so a host sync in a program raises
    where it is rather than inside the capture (process-wide: for
    single-threaded checks, not for a server). ``timer`` (the engine's,
    else one of the set's own) times the wait for the lock as
    ``graph_wait`` and the staging of the inputs as ``graph_fill``, each
    once a run, inside the caller's span."""

    def __init__(self, device="cuda", check_syncs: bool = False,
                 timer: Optional[StageTimer] = None) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"GraphSet needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.check_syncs = check_syncs
        self.enabled = True
        self.timer = timer if timer is not None else StageTimer()
        self.programs: Dict[Hashable, CapturedProgram] = {}
        self.lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle()
        self._inputs: Dict[Tuple, torch.Tensor] = {}
        self._staging: Dict[Tuple, torch.Tensor] = {}

    def run(self, key: Hashable, fn: Program,
            inputs: Inputs) -> Tuple[np.ndarray, ...]:
        """``fn(**inputs)`` on the card, the outputs on the host: the
        key's graph replayed (captured first if the key is new), or op
        by op when the set is disabled. ``fn`` must compute the same
        function for every call with one key."""
        if not self.enabled:
            return run_eager(fn, inputs, self.device)
        with self.timer.stage("graph_wait"):
            self.lock.acquire()
        try:
            prog = self.programs.get(key)
            if prog is None:
                prog = self._capture(key, fn, inputs)
            else:
                self._fill(prog.inputs, inputs)
            prog.replay()
            return to_host(prog.outputs)
        finally:
            self.lock.release()

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds for the set's memory pool
        (its graphs' intermediates and outputs)."""
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def input_bytes(self) -> int:
        """Bytes of the static input buffers (outside the pool)."""
        return sum(t.numel() * t.element_size() for t in self._inputs.values())

    def stats(self) -> Dict:
        """Graphs, replays, capture seconds and memory, for logs."""
        progs: List[CapturedProgram] = list(self.programs.values())
        return {
            "graphs": len(progs),
            "replays": sum(p.replays for p in progs),
            "capture_s": [round(p.capture_s, 4) for p in progs],
            "pool_bytes": self.pool_bytes(),
            "input_bytes": self.input_bytes(),
        }

    def summary(self) -> str:
        """One log line of :meth:`stats`."""
        st = self.stats()
        return (f"captured {st['graphs']} CUDA graphs "
                f"({sum(st['capture_s']):.2f} s of capture); graph pool "
                f"{st['pool_bytes']} bytes, static inputs "
                f"{st['input_bytes']} bytes")

    # -- internals -----------------------------------------------------------

    def _buffers(self, inputs: Inputs) -> Dict[str, torch.Tensor]:
        """The static device buffers of these inputs' names and shapes,
        made on first use (outside the pool) with pinned staging."""
        out = {}
        for name, a in inputs.items():
            a = np.asarray(a)
            slot = (name, a.shape, a.dtype.str)
            buf = self._inputs.get(slot)
            if buf is None:
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                buf = torch.empty(a.shape, dtype=dtype, device=self.device)
                self._inputs[slot] = buf
                self._staging[slot] = torch.empty(a.shape, dtype=dtype,
                                                  pin_memory=True)
            out[name] = buf
        return out

    def _fill(self, bufs: Dict[str, torch.Tensor], inputs: Inputs) -> None:
        """Every static input overwritten whole: host array -> pinned
        staging -> device, on the current stream. The lock is held until
        the outputs are on the host, so the staging is not reused while
        a copy from it may be in flight. Timed as ``graph_fill``."""
        with self.timer.stage("graph_fill"):
            for name, a in inputs.items():
                a = np.asarray(a)
                staging = self._staging[(name, a.shape, a.dtype.str)]
                # torch's host copy runs on its thread pool (a 64-query
                # postings batch at the 131,072 cap is 67 MB)
                staging.copy_(torch.from_numpy(a))
                bufs[name].copy_(staging, non_blocking=True)

    def _capture(self, key: Hashable, fn: Program,
                 inputs: Inputs) -> CapturedProgram:
        t0 = time.perf_counter()
        bufs = self._buffers(inputs)
        self._fill(bufs, inputs)
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side), _syncs_raise(self.check_syncs):
                fn(**bufs)
            current.wait_stream(side)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                      capture_error_mode="thread_local"):
                    outputs = tuple(fn(**bufs))
            finally:
                # what the wrappers counted while capturing was recorded,
                # not launched
                launches = {}
                for kernel, was in before.items():
                    delta = {n: v - was[n] for n, v in kernel.counts().items()
                             if v != was[n]}
                    if delta:
                        kernel.uncount(delta)
                        launches[kernel] = delta
        prog = CapturedProgram(graph, bufs, outputs, launches,
                               time.perf_counter() - t0)
        self.programs[key] = prog
        return prog


def run_program(graphs: Optional[GraphSet], key: Hashable, fn: Program,
                inputs: Inputs, device: torch.device) -> Tuple[np.ndarray, ...]:
    """The one entry of a served program: the graph set's replay where
    there is one, else ``fn`` op by op on ``device`` (the CPU, or a
    placement that graphs do not cover)."""
    if graphs is not None:
        return graphs.run(key, fn, inputs)
    return run_eager(fn, inputs, device)
