"""The request coalescer (``server/batching.py``): a lone call dispatches
at once on its own thread; calls that arrive during a dispatch gather
behind it, and their group runs on its leader's thread when a dispatch
in flight ends, at ``window_s`` after the leader's submit, or at once
when the pending queries reach ``max_batch``. On a stub ``fn`` each test
asserts one rule; on a small synthetic CPU store every caller's rows
equal those of its own call with coalescing off, on both paths."""

import threading
import time

import numpy as np
import pytest

from legal_rag_tpu_torch.server.batching import RequestCoalescer

WAIT_S = 30.0


class Stub:
    """``fn`` for a coalescer: records each dispatch's queries, k, mode
    and thread, answers each query with ``(query, k, mode)``, and holds
    the dispatches of the queries in ``gated`` until ``gate`` is set."""

    def __init__(self, gated=()):
        self.calls = []
        self.gated = set(gated)
        self.gate = threading.Event()
        self.started = threading.Event()
        self.lock = threading.Lock()

    def __call__(self, queries, k, hybrid_weights, mode):
        with self.lock:
            self.calls.append(dict(queries=list(queries), k=k, mode=mode,
                                   weights=list(hybrid_weights),
                                   thread=threading.get_ident(),
                                   at=time.perf_counter()))
        if self.gated & set(queries):
            self.started.set()
            assert self.gate.wait(WAIT_S)
        return [[(q, k, mode)] for q in queries]


def _call(co, out, name, queries, k=5, mode="rrf"):
    """A thread that submits ``queries`` and keeps its rows, its error
    and its own thread id in ``out[name]``."""
    def run():
        rec = out.setdefault(name, {})
        rec["thread"] = threading.get_ident()
        try:
            rec["rows"] = co.submit(queries, k, [0.5] * len(queries), mode)
        except Exception as e:          # noqa: BLE001 — the test reads it
            rec["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def _pending(co, n):
    _until(lambda: len(co._pending) == n)


def _join(threads):
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)


def test_lone_call_runs_on_the_callers_thread_and_starts_no_thread(
        monkeypatch):
    stub = Stub()
    co = RequestCoalescer(stub, window_s=5.0, max_batch=64)
    started = []
    real_start = threading.Thread.start

    def start(self):
        started.append(type(self))
        return real_start(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    t0 = time.perf_counter()
    rows = co.submit(["a", "b"], 5, [0.5, 0.5], "rrf")
    took = time.perf_counter() - t0
    assert rows == [[("a", 5, "rrf")], [("b", 5, "rrf")]]
    assert started == []                 # no threading.Timer, no thread
    assert stub.calls[0]["thread"] == threading.get_ident()
    assert took < 1.0                    # no 5 s window spent
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (1, 1, 1)


def test_calls_during_a_dispatch_form_one_group():
    stub = Stub(gated={"first"})
    co = RequestCoalescer(stub, window_s=5.0, max_batch=64)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    names = [f"q{i}" for i in range(6)]
    for i, name in enumerate(names):
        threads.append(_call(co, out, name, [name]))
        _pending(co, i + 1)      # in turn, so q0 is the group's leader
    stub.gate.set()
    _join(threads)
    assert [c["queries"] for c in stub.calls] == [["first"], names]
    assert stub.calls[1]["thread"] == out["q0"]["thread"]
    for name in names:
        assert out[name]["rows"] == [[(name, 5, "rrf")]]
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (7, 2, 1)


def test_group_dispatches_when_the_dispatch_in_flight_ends():
    stub = Stub(gated={"first"})
    co = RequestCoalescer(stub, window_s=5.0, max_batch=64)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    threads.append(_call(co, out, "next", ["next"]))
    _pending(co, 1)
    time.sleep(0.05)
    assert len(stub.calls) == 1          # the leader waits for the end
    released = time.perf_counter()
    stub.gate.set()
    _join(threads)
    # well inside the 5 s window: the end of the dispatch woke the leader
    assert stub.calls[1]["at"] - released < 1.0


def test_group_dispatches_at_the_window_if_the_dispatch_in_flight_runs_on():
    window_s = 0.05
    stub = Stub(gated={"first"})
    co = RequestCoalescer(stub, window_s=window_s, max_batch=64)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    threads.append(_call(co, out, "next", ["next"]))
    # the group runs while the first dispatch is still held
    _until(lambda: len(stub.calls) == 2)
    _until(lambda: "rows" in out["next"])
    assert "rows" not in out["first"]
    waited = stub.calls[1]["at"] - stub.calls[0]["at"]
    assert waited >= window_s
    assert co._in_flight == 1
    stub.gate.set()
    _join(threads)
    assert out["next"]["rows"] == [[("next", 5, "rrf")]]
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (2, 2, 1)


def test_reaching_max_batch_dispatches_at_once():
    stub = Stub(gated={"first"})
    co = RequestCoalescer(stub, window_s=5.0, max_batch=4)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    threads.append(_call(co, out, "a", ["a"]))
    _pending(co, 1)
    threads.append(_call(co, out, "b", ["b"]))
    _pending(co, 2)
    # two more queries bring the pending ones to max_batch: dispatched
    # on this caller's thread while the first dispatch is still held
    threads.append(_call(co, out, "c", ["c1", "c2"]))
    _until(lambda: "rows" in out["c"])
    assert "rows" not in out["first"]
    assert stub.calls[1]["queries"] == ["a", "b", "c1", "c2"]
    assert stub.calls[1]["thread"] == out["c"]["thread"]
    stub.gate.set()
    _join(threads)
    assert out["a"]["rows"] == [[("a", 5, "rrf")]]
    assert out["c"]["rows"] == [[("c1", 5, "rrf")], [("c2", 5, "rrf")]]
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (4, 2, 1)


def test_groups_are_split_by_k_and_mode():
    stub = Stub(gated={"first"})
    co = RequestCoalescer(stub, window_s=5.0, max_batch=64)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    calls = [("a", ["a1", "a2"], 5, "rrf"), ("b", ["b"], 5, "weighted"),
             ("c", ["c"], 3, "rrf"), ("d", ["d1", "d2", "d3"], 5, "rrf")]
    for i, (name, qs, k, mode) in enumerate(calls):
        threads.append(_call(co, out, name, qs, k=k, mode=mode))
        _pending(co, i + 1)
    stub.gate.set()
    _join(threads)
    groups = [(c["queries"], c["k"], c["mode"]) for c in stub.calls[1:]]
    assert groups == [(["a1", "a2", "d1", "d2", "d3"], 5, "rrf"),
                      (["b"], 5, "weighted"), (["c"], 3, "rrf")]
    for name, qs, k, mode in calls:
        assert out[name]["rows"] == [[(q, k, mode)] for q in qs]
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (5, 4, 1)


def test_an_error_fans_out_to_every_caller_of_its_group():
    stub = Stub(gated={"first"})

    def fn(queries, k, hybrid_weights, mode):
        rows = stub(queries, k, hybrid_weights, mode)
        if k == 3:
            raise ValueError("bad group")
        return rows

    co = RequestCoalescer(fn, window_s=5.0, max_batch=64)
    out = {}
    threads = [_call(co, out, "first", ["first"])]
    assert stub.started.wait(WAIT_S)
    calls = [("a", 3), ("b", 5), ("c", 3)]
    for i, (name, k) in enumerate(calls):
        threads.append(_call(co, out, name, [name], k=k))
        _pending(co, i + 1)
    stub.gate.set()
    _join(threads)
    assert str(out["a"]["error"]) == str(out["c"]["error"]) == "bad group"
    assert out["a"]["error"] is out["c"]["error"]
    assert out["b"]["rows"] == [[("b", 5, "rrf")]]
    assert out["first"]["rows"] == [[("first", 5, "rrf")]]
    # the failed group ended its dispatch: the next lone call runs at once
    assert co._in_flight == 0
    assert co.submit(["e"], 5, [0.5], "rrf") == [[("e", 5, "rrf")]]
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (5, 4, 2)


def test_counters_over_lone_and_gathered_calls():
    """Lone calls in turn each dispatch at once; a burst behind a held
    dispatch is one dispatch more; ``coalesce_wait`` is one entry a
    call."""
    from legal_rag_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    stub = Stub(gated={"held"})
    co = RequestCoalescer(stub, window_s=5.0, max_batch=64,
                          stage_timer=timer)
    for i in range(5):
        co.submit([f"lone{i}"], 5, [0.5], "rrf")
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (5, 5, 5)
    out = {}
    threads = [_call(co, out, "held", ["held"])]
    assert stub.started.wait(WAIT_S)
    for i in range(8):
        threads.append(_call(co, out, f"b{i}", [f"b{i}"]))
        _pending(co, i + 1)
    stub.gate.set()
    _join(threads)
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (14, 7, 6)
    assert timer.snapshot()["coalesce_wait"]["count"] == 14


# -- equal results with and without coalescing, on a CPU store ------------

@pytest.fixture(scope="module")
def engine():
    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    cfg = EncoderConfig(hidden=96, layers=1, heads=4, intermediate=96,
                        max_len=32)
    store = synthesize_store(600, seed=11, cfg=cfg, vocab_size=2000,
                             device="cpu")
    return RetrievalEngine(store, device="cpu")


def _calls(engine, n, seed):
    """``n`` calls of 1-4 queries (3-6 consecutive words of a stored
    chunk), each with its own k and mode."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n):
        qs = []
        for _ in range(int(rng.integers(1, 5))):
            words = engine.store.chunks[int(rng.integers(600))]["text"].split()
            m = int(rng.integers(3, 7))
            at = int(rng.integers(len(words) - m))
            qs.append(" ".join(words[at:at + m]))
        calls.append((qs, int(rng.choice([3, 5])),
                      str(rng.choice(["rrf", "weighted"]))))
    return calls


def _rows(rows):
    return [[(r.doc_id, r.score) for r in row] for row in rows]


@pytest.mark.parametrize("dispatch_s, window_s", [(0.0, 0.003), (0.05, 0.5)],
                         ids=["served-window", "held-dispatch"])
def test_coalesced_rows_equal_uncoalesced(engine, dispatch_s, window_s):
    """24 threads at once, the first call dispatched at once; with
    ``dispatch_s`` added to every dispatch, the others pile up behind
    the one in flight and are gathered."""
    calls = _calls(engine, 24, seed=int(1e3 * dispatch_s) + 7)
    want = [_rows(engine._search_batch_impl(
        qs, k=k, hybrid_weights=[0.5] * len(qs), mode=mode))
        for qs, k, mode in calls]
    impl = engine._search_batch_impl

    def fn(queries, k, hybrid_weights, mode):
        time.sleep(dispatch_s)
        return impl(queries, k=k, hybrid_weights=hybrid_weights, mode=mode)

    co = RequestCoalescer(fn, window_s=window_s, max_batch=64)
    start = threading.Barrier(len(calls))
    got = [None] * len(calls)

    def run(i):
        qs, k, mode = calls[i]
        start.wait(WAIT_S)
        got[i] = _rows(co.submit(qs, k, [0.5] * len(qs), mode))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(calls))]
    for t in threads:
        t.start()
    _join(threads)
    for (qs, _, _), g, w in zip(calls, got, want):
        assert len(g) == len(w) == len(qs)
        for grow, wrow in zip(g, w):
            assert [d for d, _ in grow] == [d for d, _ in wrow]
            np.testing.assert_allclose([s for _, s in grow],
                                       [s for _, s in wrow],
                                       rtol=0, atol=1e-6)
    assert co.requests == len(calls)
    assert co.dispatched_at_once >= 1
    if dispatch_s:
        # gathered behind the dispatch in flight: fewer dispatches than
        # (k, mode) groups would need one a call
        assert co.dispatches < co.requests


def test_lone_calls_in_turn_equal_uncoalesced(engine):
    """One call at a time: each dispatched at once, on its caller's
    thread, and equal to its own uncoalesced call."""
    calls = _calls(engine, 6, seed=5)
    weight = engine.config.fusion.hybrid_weight
    engine.enable_request_coalescing()
    try:
        co = engine._coalescer
        for qs, k, mode in calls:
            got = engine.search_batch(qs, k=k, mode=mode)
            want = engine._search_batch_impl(
                qs, k=k, hybrid_weights=[weight] * len(qs), mode=mode)
            assert [[r.doc_id for r in row] for row in got] == \
                [[r.doc_id for r in row] for row in want]
            for grow, wrow in zip(got, want):
                np.testing.assert_allclose([r.score for r in grow],
                                           [r.score for r in wrow],
                                           rtol=0, atol=1e-6)
        assert co.dispatched_at_once == co.dispatches == co.requests == 6
    finally:
        engine._coalescer = None
