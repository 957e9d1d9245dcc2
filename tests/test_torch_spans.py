"""The served path's spans on the engine's one ``StageTimer``: the
request, the classifier, each search as its caller waits for it, the
coalescer's queue wait, result assembly, the cross-encoder with its
pair encoding nested in it, and the responder, on a small CPU ``LegalEngine`` with rerank and coalescing on;
the benchmark's reader of the orchestration's self time; the ranges an
all-threads profiler finds on the threads that did the work; and, on
the card, the wait for the graph set's lock and the staging of a
program's inputs inside the spans that replay."""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from legal_rag_tpu_torch.server.batching import RequestCoalescer
from legal_rag_tpu_torch.utils.timing import StageTimer

QUERIES = [
    # victim distress: the expansion's queries in one search
    "I was robbed at gunpoint just now, what do I do?",
    "What is the punishment for robbery under BNS?",
    # narrative: a second, dense-union search
    "someone is spreading made-up stories that ruined my standing",
]

REQUEST_SPANS = {"request", "classify", "search", "coalesce_wait", "encode",
                 "postings", "device_search", "assemble", "ce", "ce_tokenize",
                 "respond"}


def _legal_engine(device):
    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    cfg = EncoderConfig(hidden=96, layers=1, heads=4, intermediate=96,
                        max_len=32)
    store = synthesize_store(600, seed=3, planted=QUERIES[1:2], cfg=cfg,
                             vocab_size=2000, device=device)
    legal = LegalEngine(store=store, use_llm=False, device=device,
                        rerank=True)
    legal.engine.enable_request_coalescing()
    return legal


@pytest.fixture(scope="module")
def legal():
    legal = _legal_engine("cpu")
    for q in QUERIES:
        legal.query(q, k=5)            # first calls load what they use
    return legal


def test_coalesce_wait_is_one_entry_a_call_from_submit_to_its_dispatch():
    """One call dispatched at once on its own thread; two submitters
    during its dispatch gathered behind it, their two groups (by k) run
    in turn on the leader's thread once it ends: three waits, the first
    near zero, and the group that ran second waited at least the first
    group's whole dispatch."""
    timer = StageTimer()
    dispatch_s = 0.3
    running = threading.Event()

    def fn(queries, k, hybrid_weights, mode):
        running.set()
        time.sleep(dispatch_s)
        return [[(q, k)] for q in queries]

    co = RequestCoalescer(fn, window_s=0.5, max_batch=64, stage_timer=timer)
    got = {}

    def call(name, k):
        got[name] = co.submit([name], k, [0.5], "rrf")

    first = threading.Thread(target=call, args=("a", 1))
    first.start()
    assert running.wait(timeout=30)
    assert timer.snapshot()["coalesce_wait"]["last_ms"] < 1e3 * dispatch_s
    threads = [first] + [threading.Thread(target=call, args=a)
                         for a in (("b", 1), ("c", 2))]
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got == {"a": [[("a", 1)]], "b": [[("b", 1)]], "c": [[("c", 2)]]}
    assert (co.requests, co.dispatches, co.dispatched_at_once) == (3, 3, 1)
    snap = timer.snapshot()["coalesce_wait"]
    assert snap["count"] == 3
    # the last wait recorded is of the group that ran second
    assert snap["last_ms"] >= 1e3 * dispatch_s


def test_query_leaves_every_span_on_the_engine_timer(legal):
    assert legal.timer is legal.engine.timer
    assert legal.orchestrator.reranker.timer is legal.timer
    assert legal.engine._coalescer.stage_timer is legal.timer
    for q in QUERIES:
        legal.timer.reset()
        dispatches = legal.engine.device_dispatches
        legal.query(q, k=5)
        snap = legal.timer.snapshot()
        assert REQUEST_SPANS <= set(snap), q
        assert "graph_wait" not in snap      # no graph set on the CPU
        count = {name: st["count"] for name, st in snap.items()}
        assert count["request"] == count["classify"] == count["ce"] == \
            count["ce_tokenize"] == count["respond"] == 1
        # one search at a time: each call its own dispatch
        n = legal.engine.device_dispatches - dispatches
        assert count["search"] == count["coalesce_wait"] == n
        assert count["encode"] == count["postings"] == \
            count["device_search"] == count["assemble"] == n
        inside = sum(snap[name]["total_s"]
                     for name in ("classify", "search", "ce", "respond"))
        assert inside <= snap["request"]["total_s"]
        assert snap["ce_tokenize"]["total_s"] <= snap["ce"]["total_s"]
        assert snap["search"]["total_s"] >= snap["coalesce_wait"]["total_s"]


def test_search_batch_span_without_coalescing(legal, monkeypatch):
    monkeypatch.setattr(legal.engine, "_coalescer", None)
    legal.timer.reset()
    legal.engine.search_batch(QUERIES, k=3)
    snap = legal.timer.snapshot()
    assert snap["search"]["count"] == snap["assemble"]["count"] == 1
    assert "coalesce_wait" not in snap


def test_postings_span_holds_tokenization_budget_and_gather(legal,
                                                           monkeypatch):
    """One ``postings`` entry a dispatch, and inside it the BM25
    tokenization, the budget and the gather: sleeps planted in each
    land in the span."""
    from legal_rag_tpu_torch import native_ext
    from legal_rag_tpu_torch.ops import sparse

    monkeypatch.setattr(legal.engine, "_coalescer", None)
    sleep_s = 0.02
    slept = []

    def slow(fn):
        def wrapped(*args, **kwargs):
            time.sleep(sleep_s)
            slept.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    for owner, name in ((sparse.BM25Index, "query_term_ids"),
                        (sparse, "_pow2_at_least"),
                        (sparse.BM25Index, "gather_postings"),
                        (native_ext, "gather_postings")):
        monkeypatch.setattr(owner, name, slow(getattr(owner, name)))
    legal.timer.reset()
    legal.engine.search_batch(QUERIES, k=3)
    snap = legal.timer.snapshot()
    assert snap["postings"]["count"] == 1
    assert {"query_term_ids", "_pow2_at_least", "gather_postings"} <= \
        set(slept)
    assert snap["postings"]["total_s"] >= sleep_s * len(slept)


def _readings(legal):
    from benchmark.harness import LayerContext, reader

    legal.timer.reset()
    for q in QUERIES:
        legal.query(q, k=5)
    ctx = LayerContext(stages=legal.timer.snapshot())
    return {m: reader(m)(ctx) for m in (
        "orchestrate_ms.query", "classify_ms.query", "ce_ms.query",
        "ce_tokenize_ms.query", "respond_ms.query", "coalesce_wait_ms.query")}


def test_orchestrate_ms_is_the_request_self_time(legal, monkeypatch):
    """A sleep planted in the rule boosts (orchestration's own code)
    raises ``orchestrate_ms.query`` by about the sleep and leaves the
    spans inside the request where they were."""
    before = _readings(legal)
    assert all(v is not None for v in before.values())
    assert before["orchestrate_ms.query"] >= 0
    sleep_s = 0.5
    boost = legal.orchestrator.prioritize_results

    def slow(results, intent):
        time.sleep(sleep_s)
        return boost(results, intent)

    monkeypatch.setattr(legal.orchestrator, "prioritize_results", slow)
    after = _readings(legal)
    rise = after["orchestrate_ms.query"] - before["orchestrate_ms.query"]
    assert 0.9 * 1e3 * sleep_s <= rise <= 1.5 * 1e3 * sleep_s
    for m in ("classify_ms.query", "ce_ms.query", "ce_tokenize_ms.query",
              "respond_ms.query"):
        assert abs(after[m] - before[m]) < 0.25 * 1e3 * sleep_s, m


def test_ce_tokenize_nests_in_ce(legal, monkeypatch):
    """A sleep planted in the pair encoding raises ``ce_tokenize_ms`` by
    about the sleep (one call a request), lies inside ``ce``, and leaves
    ``orchestrate_ms.query``, which subtracts ``ce``, where it was."""
    before = _readings(legal)
    sleep_s = 0.5
    ce = legal.orchestrator.reranker
    assert ce.pair_encoder_impl == "python"
    encode = ce.encode_pairs

    def slow(*args, **kwargs):
        time.sleep(sleep_s)
        return encode(*args, **kwargs)

    monkeypatch.setattr(ce, "encode_pairs", slow)
    after = _readings(legal)
    rise = after["ce_tokenize_ms.query"] - before["ce_tokenize_ms.query"]
    assert 0.9 * 1e3 * sleep_s <= rise <= 1.5 * 1e3 * sleep_s
    assert after["ce_ms.query"] >= after["ce_tokenize_ms.query"]
    for m in ("orchestrate_ms.query", "classify_ms.query",
              "respond_ms.query"):
        assert abs(after[m] - before[m]) < 0.25 * 1e3 * sleep_s, m


def test_readers_of_a_program_without_the_spans_read_nothing():
    from benchmark.harness import LayerContext, reader

    ctx = LayerContext(stages={"encode": {"count": 4, "total_s": 0.01}})
    for m in ("orchestrate_ms.query", "classify_ms.query", "ce_ms.query",
              "ce_tokenize_ms.query", "respond_ms.query",
              "coalesce_wait_ms.query",
              "graph_wait_ms.query", "assemble_ms.search"):
        assert reader(m)(ctx) is None, m


def test_spans_reach_an_all_threads_trace_on_their_own_threads(
        legal, monkeypatch, tmp_path):
    """Under ``LEGAL_RAG_PROFILE``, a profiler started on all threads
    holds the request's ranges on the pool worker that served it, and the
    search's there too: with nothing in flight, the worker that submitted
    the search dispatched it itself."""
    from torch._C._profiler import _ExperimentalConfig

    monkeypatch.setenv("LEGAL_RAG_PROFILE", "1")
    co = legal.engine._coalescer
    dispatch = co._fn
    threads = {}

    def on_thread(*args, **kwargs):
        threads["dispatch"] = (threading.get_native_id(),
                               type(threading.current_thread()))
        return dispatch(*args, **kwargs)

    def serve():
        threads["worker"] = threading.get_native_id()
        return legal.query(QUERIES[1], k=5)

    monkeypatch.setattr(co, "_fn", on_thread)
    with ThreadPoolExecutor(max_workers=2) as pool:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True)) as prof:
            pool.submit(serve).result(timeout=60)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    tids = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            tids.setdefault(e["name"], set()).add(e["tid"])
    worker = threads["worker"]
    dispatcher, kind = threads["dispatch"]
    assert dispatcher == worker and not issubclass(kind, threading.Timer)
    assert worker in tids["request"] and worker in tids["classify"]
    assert worker in tids["device_search"]
    # the pair encoding: one range, inside the request's one ce range
    ranges = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("name") == name
                     and e.get("cat") == "user_annotation"
                     and e["tid"] == worker]
              for name in ("ce", "ce_tokenize")}
    assert len(ranges["ce"]) == len(ranges["ce_tokenize"]) == 1
    (ce_a, ce_b), (tok_a, tok_b) = ranges["ce"][0], ranges["ce_tokenize"][0]
    assert ce_a <= tok_a and tok_b <= ce_b


# -- on the card -----------------------------------------------------------

@pytest.mark.gpu
def test_graph_wait_is_inside_the_spans_that_replay(monkeypatch, tmp_path):
    """On the card every replay of the search, the encoder and the
    cross-encoder waits for the graph set's lock inside its own span:
    one ``graph_wait`` a span, each range within one of theirs on the
    same thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph set and its lock exist "
                    "only there")
    from torch._C._profiler import _ExperimentalConfig

    legal = _legal_engine("cuda")
    assert legal.engine.graphs.timer is legal.timer
    for q in QUERIES:
        legal.query(q, k=5)             # captured
    monkeypatch.setenv("LEGAL_RAG_PROFILE", "1")
    legal.timer.reset()
    # the searches run on the threads that submit them
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        for q in QUERIES:
            legal.query(q, k=5)
    count = {n: st["count"] for n, st in legal.timer.snapshot().items()}
    assert count["graph_wait"] == \
        count["encode"] + count["device_search"] + count["ce"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    waits = [r for r in ranges if r[2] == "graph_wait"]
    assert len(waits) == count["graph_wait"]
    outer = [r for r in ranges if r[2] in ("encode", "device_search", "ce")]
    for a, b, _, tid in waits:
        assert any(oa <= a and b <= ob and ot == tid
                   for oa, ob, _, ot in outer), (a, b)


@pytest.mark.gpu
def test_graph_fill_is_once_a_replay_inside_its_dispatch_span(monkeypatch,
                                                              tmp_path):
    """On the card each replay stages its inputs once, as ``graph_fill``
    on the engine's timer, and under ``LEGAL_RAG_PROFILE`` the range
    lies within the span that replays (``encode``, ``device_search`` or
    ``ce``) on the same thread, after that replay's ``graph_wait``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph set stages inputs only "
                    "there")
    from torch._C._profiler import _ExperimentalConfig

    legal = _legal_engine("cuda")
    for q in QUERIES:
        legal.query(q, k=5)             # captured
    monkeypatch.setenv("LEGAL_RAG_PROFILE", "1")
    legal.timer.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        for q in QUERIES:
            legal.query(q, k=5)
    count = {n: st["count"] for n, st in legal.timer.snapshot().items()}
    replays = count["encode"] + count["device_search"] + count["ce"]
    assert count["graph_fill"] == count["graph_wait"] == replays
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    fills = [r for r in ranges if r[2] == "graph_fill"]
    assert len(fills) == replays
    outer = [r for r in ranges if r[2] in ("encode", "device_search", "ce")]
    waits = [r for r in ranges if r[2] == "graph_wait"]
    for a, b, _, tid in fills:
        assert any(oa <= a and b <= ob and ot == tid
                   for oa, ob, _, ot in outer), (a, b)
        assert any(wb <= a and wt == tid for _, wb, _, wt in waits), (a, b)
