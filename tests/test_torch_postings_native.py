"""The served search's BM25 postings gather in one C++ call
(``ops.sparse.gather_postings_batch``, ``native/postings_gather.cpp``)
against the verbatim copy of the JAX package's host gather: the budget
``_pad_pow2(BM25Index.postings_budget(queries, cap))`` and the ``(ids,
weights)`` of ``BM25Index.gather_postings`` equal byte for byte, over a
synthetic corpus in the five laws' shape with the benchmark's
chunk-word queries, over the edge cases of the query text and of the
CSR, under the budget cap's cut by weight (ties included), and from 16
threads at once. Also the engine: ``search_batch`` answers as on the
Python path, and counts its gathers and cuts."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from benchmark.data.legal_corpus import legal_chunks
from benchmark.traffic.generator import chunk_word_queries
from legal_rag_tpu_torch import native_ext
from legal_rag_tpu_torch.ops.sparse import (
    BM25Index, build_bm25, gather_postings_batch,
)
from legal_rag_tpu_torch.retrieval.engine import _pad_pow2

CAP = 1 << 17       # BM25Config.postings_budget_cap
SEARCH64 = {"min_words": 3, "max_words": 8}     # traffic/search64.json


@pytest.fixture(scope="module", autouse=True)
def native():
    if not native_ext.build_native():
        pytest.skip("no C++ compiler builds the native library")


@pytest.fixture(scope="module")
def legal():
    """The legal corpus's BM25 index and 8 batches of 64 search64-style
    queries."""
    chunks = legal_chunks(2004, n_chunks=1200)
    index = build_bm25([c["text"] for c in chunks])
    qs = chunk_word_queries(SEARCH64, chunks, 8 * 64,
                            np.random.default_rng(2004))
    return index, [qs[i:i + 64] for i in range(0, len(qs), 64)]


def _verbatim(index, queries, cap, lo=8):
    budget = _pad_pow2(index.postings_budget(queries, cap=cap), lo)
    return (budget, *index.gather_postings(queries, budget))


def _assert_equal(index, queries, cap=CAP, lo=8):
    budget, ids, w = _verbatim(index, queries, cap, lo)
    got = gather_postings_batch(index, queries, cap=cap, lo=lo)
    assert got.impl == "native-cpp"
    assert got.budget == budget
    assert got.ids.dtype == np.int32 and got.weights.dtype == np.float32
    assert got.ids.shape == got.weights.shape == (len(queries), budget)
    assert got.ids.tobytes() == ids.tobytes()
    assert got.weights.tobytes() == w.tobytes()
    return got


def _totals(index, queries):
    return [sum(int(index.indptr[t + 1] - index.indptr[t])
                for t in set(index.query_term_ids(q))) for q in queries]


def _csr(lists, n_docs, vocab=None):
    """A hand-made index: term i's postings ``lists[i]`` of (doc,
    weight)."""
    indptr = np.zeros(len(lists) + 1, np.int64)
    indptr[1:] = np.cumsum([len(p) for p in lists])
    flat = [pw for p in lists for pw in p]
    return BM25Index(
        vocab=vocab or {f"t{i}": i for i in range(len(lists))},
        indptr=indptr,
        doc_ids=np.array([d for d, _ in flat], np.int32).reshape(-1),
        weights=np.array([w for _, w in flat], np.float32).reshape(-1),
        idf=np.ones(len(lists), np.float32),
        doc_len=np.ones(n_docs, np.int32), n_docs=n_docs, avgdl=1.0,
        k1=1.5, b=0.75, epsilon=0.25)


@pytest.mark.parametrize(
    "cap,lo", [(CAP, 8), (512, 8), (64, 8), (None, 8), (None, 64)],
    ids=["131072", "512", "64", "uncapped", "uncapped-lo64"])
def test_search64_batches_equal_the_verbatim_gather(legal, cap, lo):
    """Every batch at the served cap (no cut), at caps that cut most
    queries by weight, and with no cap at the floors of the
    evaluation's BM25 ranking (8) and of ``bench.bench_inputs`` (64)."""
    index, batches = legal
    truncated = 0
    for batch in batches:
        got = _assert_equal(index, batch, cap, lo)
        over = sum(t > got.budget for t in _totals(index, batch))
        assert got.truncated == over
        truncated += over
    assert (truncated == 0) == (cap in (CAP, None))


@pytest.mark.parametrize("q", [1, 8, 64])
def test_batch_sizes(legal, q):
    index, batches = legal
    _assert_equal(index, batches[1][:q])
    _assert_equal(index, batches[2][:q], cap=16)


def test_repeats_unknown_terms_and_empty_queries(legal):
    """Terms 2-3 times (their weights scaled), words outside the
    vocabulary, empty and blank texts, and the engine's "" padding
    rows."""
    index, batches = legal
    words = batches[0][0].split()
    a, b = words[0], words[-1]
    queries = [
        f"{a} {a} {b}", f"{a} {b} {a} {b} {a}", f"{a.upper()} zzqx {a}",
        "zzqx qqzv", "", "   ", f"{b} {b} {b}", batches[0][3],
    ]
    got = _assert_equal(index, queries + [""] * 8)
    assert (got.ids[3:6] == index.n_docs).all()
    assert (got.weights[3:6] == 0).all()
    _assert_equal(index, queries, cap=8)


def test_empty_posting_list_and_a_total_equal_to_the_budget():
    """A term with no postings; totals of exactly the budget (8, then 16
    under a cap of 16) are not cut, one past it is."""
    index = _csr([[(0, 1.0), (3, 2.0), (5, 0.5), (6, 1.5), (7, 1.0)], [],
                  [(1, 0.25), (2, 0.75), (4, 3.0)],
                  [(d, 0.1 * d) for d in range(8)],
                  [(d, 1.0) for d in range(9)]], n_docs=10)
    for queries, cap in ((["t1"], None), (["t0 t1 t2"], None),
                         (["t0 t2", "t1", ""], None),
                         (["t0 t2 t3", "t3 t3 t1"], 16),
                         (["t3 t4", "t0"], 16), (["t4"], 8)):
        got = _assert_equal(index, queries, cap)
        totals = _totals(index, queries)
        assert got.truncated == sum(t > got.budget for t in totals)
    assert gather_postings_batch(index, ["t0 t2 t3"], cap=16).truncated == 0
    assert gather_postings_batch(index, ["t4"], cap=8).truncated == 1


def test_equal_weights_at_the_cut_fall_as_argpartition_chooses():
    """Many postings of one weight across the cut: the kept set, and its
    order, are np.argpartition's on the same float32 weights."""
    rng = np.random.default_rng(7)
    lists = [[(int(d), float(w)) for d, w in zip(
        rng.permutation(300)[:n], rng.choice([0.5, 1.0, 1.0, 2.0], n))]
        for n in (120, 90, 200, 60)]
    index = _csr(lists, n_docs=300)
    queries = ["t0 t1", "t2 t3 t0", "t1 t1 t3", "t3", "t2 t2 t0 t1 t3"]
    for cap in (8, 32, 64, 100, 128):
        got = _assert_equal(index, queries, cap)
        assert got.truncated > 0
        # a cut row is full: no padding
        for qi, total in enumerate(_totals(index, queries)):
            if total > got.budget:
                assert (got.ids[qi] < index.n_docs).all()


def test_reported_totals_and_spill_check(legal):
    """The native call reports each query's total; spill offsets that
    do not hold an over-budget query's total raise instead of writing
    past them."""
    index, batches = legal
    batch = batches[3][:16]
    counts = [dict.fromkeys(index.query_term_ids(q), 0) for q in batch]
    for q, c in zip(batch, counts):
        for t in index.query_term_ids(q):
            c[t] += 1
    terms = np.array([t for c in counts for t in c], np.int64)
    mult = np.array([m for c in counts for m in c.values()], np.float32)
    offsets = np.cumsum([0] + [len(c) for c in counts])
    budget = 1 << 20
    *_, totals, _, _ = native_ext.gather_postings(
        terms, mult, offsets, index.indptr, index.doc_ids, index.weights,
        index.n_docs, budget, np.zeros(len(batch) + 1, np.int64))
    assert totals.tolist() == _totals(index, batch)
    with pytest.raises(ValueError):
        native_ext.gather_postings(
            terms, mult, offsets, index.indptr, index.doc_ids, index.weights,
            index.n_docs, 8, np.zeros(len(batch) + 1, np.int64))
    with pytest.raises(ValueError):
        native_ext.gather_postings(
            terms + len(index.indptr), mult, offsets, index.indptr,
            index.doc_ids, index.weights, index.n_docs, budget,
            np.zeros(len(batch) + 1, np.int64))


def test_sixteen_threads_at_once(legal):
    index, batches = legal
    work = [(b, cap) for b in batches for cap in (CAP, 256)] * 2
    want = [_verbatim(index, b, cap) for b, cap in work]
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(
            lambda a: gather_postings_batch(index, a[0], cap=a[1]), work))
    for (budget, ids, w), g in zip(want, got):
        assert g.budget == budget
        assert g.ids.tobytes() == ids.tobytes()
        assert g.weights.tobytes() == w.tobytes()


def test_python_path_where_the_library_is_missing(legal, monkeypatch):
    index, batches = legal
    monkeypatch.setattr(native_ext, "native_available", lambda: False)
    budget, ids, w = _verbatim(index, batches[0], 64)
    got = gather_postings_batch(index, batches[0], cap=64)
    assert (got.impl, got.truncated) == ("python", 0)
    assert got.budget == budget
    assert got.ids.tobytes() == ids.tobytes()
    assert got.weights.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def engine():
    from legal_rag_tpu_torch.config import (
        BM25Config, EncoderConfig, RetrievalConfig, ShardingConfig,
    )
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    enc = EncoderConfig(hidden=64, layers=1, heads=4, intermediate=64,
                        max_len=32)
    store = synthesize_store(800, seed=11, cfg=enc, vocab_size=3000,
                             device="cpu")
    # a cap the function words pass, so the served path cuts by weight
    cfg = RetrievalConfig(encoder=enc, bm25=BM25Config(postings_budget_cap=64),
                          sharding=ShardingConfig(num_shards=1))
    return RetrievalEngine(store, config=cfg, device="cpu")


def _answers(results):
    return [[(r.doc_id, r.score, r.semantic, r.keyword) for r in row]
            for row in results]


@pytest.mark.parametrize("mode", ["rrf", "weighted"])
def test_engine_answers_as_the_python_path_and_counts(engine, monkeypatch,
                                                      mode):
    words = [c["text"].split() for c in engine.store.chunks[:40]]
    queries = [" ".join(w[i:i + 2 + i % 5]) for i, w in enumerate(words)]
    queries += ["", "the of the", "zzqx"]
    before = dict(engine.postings_gathers)
    cut = engine.postings_truncated
    native = engine.search_batch(queries, k=5, mode=mode)
    assert engine.postings_gathers["native-cpp"] == before["native-cpp"] + 1
    budget = _pad_pow2(engine.store.bm25.postings_budget(queries, cap=64))
    over = sum(t > budget for t in _totals(engine.store.bm25,
                                           queries + [""] * 21))
    assert over > 0
    assert engine.postings_truncated == cut + over
    monkeypatch.setattr(native_ext, "native_available", lambda: False)
    python = engine.search_batch(queries, k=5, mode=mode)
    assert engine.postings_gathers == {
        "native-cpp": before["native-cpp"] + 1,
        "python": before["python"] + 1}
    assert engine.postings_truncated == cut + over
    assert _answers(native) == _answers(python)
