"""Cross-request micro-batching for the serving edge.

The framework's core is arrays-as-interface — one ``[Q, D]`` query
matrix, one device program (SURVEY.md §7). The reference serves each
HTTP request as its own sequential search (reference
src/server/app.py:109 -> retrieval_engine.py:59); this coalescer
applies the batched core AT the serving edge: concurrent ``/query`` /
``/api/v1/batch_search`` requests that arrive within a few-millisecond
window are concatenated into ONE ``search_batch`` device dispatch and
the results are split back per caller.

Thread-model: callers (server worker threads) block on an event; the
flush runs on whichever thread triggers it (the max-batch submitter or
the window timer), so there is no dedicated dispatcher thread to keep
alive. Requests are grouped by ``(k, mode)`` — different shapes would
recompile, not coalesce.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Item:
    __slots__ = ("queries", "k", "weights", "mode", "event", "result", "error")
    __slots__ += ("t_submit",)

    def __init__(self, queries, k, weights, mode):
        self.queries = list(queries)
        self.k = k
        self.weights = list(weights)
        self.mode = mode
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()


class RequestCoalescer:
    """Coalesces concurrent search_batch calls into shared dispatches.

    ``fn`` is the underlying batched search implementation with the
    signature ``fn(queries, k=..., hybrid_weights=..., mode=...)``
    returning one result row per query.
    """

    def __init__(
        self,
        fn: Callable,
        window_s: float = 0.003,
        max_batch: int = 64,
        timeout_s: float = 120.0,
        stage_timer=None,
    ):
        self._fn = fn
        self._window = window_s
        self._max = max_batch
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._pending: List[_Item] = []
        self._timer: Optional[threading.Timer] = None
        # observability: how many caller requests were served by how
        # many device dispatches
        self.requests = 0
        self.dispatches = 0
        # each call's queue wait, from submit to the start of its
        # group's dispatch, as ``coalesce_wait`` on the engine's timer
        self.stage_timer = stage_timer

    def submit(
        self,
        queries: Sequence[str],
        k: int,
        weights: Sequence[float],
        mode: str,
    ):
        item = _Item(queries, k, weights, mode)
        run_now: Optional[List[_Item]] = None
        with self._lock:
            self.requests += 1
            self._pending.append(item)
            if sum(len(i.queries) for i in self._pending) >= self._max:
                run_now = self._drain_locked()
            elif self._timer is None:
                self._timer = threading.Timer(self._window, self._flush)
                self._timer.daemon = True
                self._timer.start()
        if run_now:
            self._run(run_now)
        if not item.event.wait(self._timeout):
            raise RuntimeError("coalesced search timed out")
        if item.error is not None:
            raise item.error
        return item.result

    # -- internals -----------------------------------------------------------

    def _drain_locked(self) -> List[_Item]:
        batch, self._pending = self._pending, []
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return batch

    def _flush(self) -> None:
        with self._lock:
            batch = self._drain_locked()
        if batch:
            self._run(batch)

    def _run(self, batch: List[_Item]) -> None:
        groups: Dict[Tuple[int, str], List[_Item]] = {}
        for item in batch:
            groups.setdefault((item.k, item.mode), []).append(item)
        for (k, mode), items in groups.items():
            queries: List[str] = []
            weights: List[float] = []
            for it in items:
                queries.extend(it.queries)
                weights.extend(it.weights)
            try:
                with self._lock:
                    self.dispatches += 1
                if self.stage_timer is not None:
                    now = time.perf_counter()
                    for it in items:
                        self.stage_timer.add("coalesce_wait",
                                             now - it.t_submit)
                rows = self._fn(
                    queries, k=k, hybrid_weights=weights, mode=mode
                )
                lo = 0
                for it in items:
                    it.result = rows[lo : lo + len(it.queries)]
                    lo += len(it.queries)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for it in items:
                    it.error = e
            finally:
                for it in items:
                    it.event.set()
