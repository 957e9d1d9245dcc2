"""Cross-request micro-batching for the serving edge.

The framework's core is arrays-as-interface — one ``[Q, D]`` query
matrix, one device program (SURVEY.md §7). The reference serves each
HTTP request as its own sequential search (reference
src/server/app.py:109 -> retrieval_engine.py:59); this coalescer
applies the batched core AT the serving edge: concurrent ``/query`` /
``/api/v1/batch_search`` requests that arrive while a dispatch is in
flight are concatenated into ONE ``search_batch`` device dispatch and
the results are split back per caller.

Thread-model: a call that finds no dispatch in flight and no group
pending runs its search at once, on its own thread. A call that arrives
during a dispatch joins the pending group; the group's first call (its
leader) waits until a dispatch in flight ends, or until ``window_s``
after its own submit, whichever comes first, and then runs the group on
its own thread. A submit that brings the pending queries to
``max_batch`` runs them at once. The other callers block on an event,
so there is no dispatcher or timer thread to keep alive. Requests are
grouped by ``(k, mode)`` — different shapes would recompile, not
coalesce.
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
    returning one result row per query. ``window_s`` bounds how long a
    call waits for company; ``max_batch`` bounds the queries a dispatch
    gathers from calls that wait.
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
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Item] = []
        # dispatches running now, and how many have ended: a pending
        # group's leader waits for the count of ended ones to move
        self._in_flight = 0
        self._ended = 0
        # observability: how many caller requests were served by how
        # many device dispatches, and how many of those a lone call
        # ran at once (nothing in flight, nothing pending)
        self.requests = 0
        self.dispatches = 0
        self.dispatched_at_once = 0
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
        batch: Optional[List[_Item]] = None
        with self._lock:
            self.requests += 1
            lone = not self._pending and not self._in_flight
            self._pending.append(item)
            if lone:
                self.dispatched_at_once += 1
                batch = self._drain_locked()
            elif sum(len(i.queries) for i in self._pending) >= self._max:
                batch = self._drain_locked()
            elif self._pending[0] is item:
                batch = self._lead_locked(item)
        if batch:
            self._run(batch)
        if not item.event.wait(self._timeout):
            raise RuntimeError("coalesced search timed out")
        if item.error is not None:
            raise item.error
        return item.result

    # -- internals -----------------------------------------------------------

    def _lead_locked(self, item: _Item) -> Optional[List[_Item]]:
        """As the pending group's leader, wait until a dispatch in
        flight ends or ``window_s`` has passed since ``item``'s submit;
        then drain the group, unless a ``max_batch`` submit drained it
        first."""
        ended = self._ended
        deadline = item.t_submit + self._window
        while self._pending and self._pending[0] is item \
                and self._ended == ended:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            self._cond.wait(left)
        if self._pending and self._pending[0] is item:
            return self._drain_locked()
        return None

    def _drain_locked(self) -> List[_Item]:
        batch, self._pending = self._pending, []
        self._in_flight += 1
        return batch

    def _run(self, batch: List[_Item]) -> None:
        try:
            self._run_groups(batch)
        finally:
            with self._lock:
                self._in_flight -= 1
                self._ended += 1
                self._cond.notify_all()

    def _run_groups(self, batch: List[_Item]) -> None:
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
