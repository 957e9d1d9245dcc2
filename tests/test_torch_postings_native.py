"""The served search's BM25 postings gather in one C++ call
(``ops.sparse.gather_postings_batch``, ``native/postings_gather.cpp``).

Its rows are held, bit for bit (ids, weights and row order), to
``ops.sparse.cut_by_weight`` applied to each query's uncut gather, and
to the verbatim copy of the JAX package's host gather
(``BM25Index.gather_postings``) under the tie-aware predicate: the budget
``_pad_pow2(BM25Index.postings_budget(queries, cap))`` equal, a row that
fits equal byte for byte, and a cut row with the same postings above the
cut weight ``c``, as many at ``c``, each of them one of the verbatim's
postings at ``c``, and the verbatim's very postings where no group of
equal weights straddles the cut. Over a synthetic corpus in the five
laws' shape with the benchmark's chunk-word queries, over the edge cases
of the query text and of the CSR, over rows with heavy ties, and from 16
threads at once. Also the Python path where the library is missing, and
the engine: ``search_batch`` answers as on the Python path, and counts
its gathers, cuts and ties and times its cut."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from benchmark.data.legal_corpus import legal_chunks
from benchmark.traffic.generator import chunk_word_queries
from legal_rag_tpu_torch import native_ext
from legal_rag_tpu_torch.ops.sparse import (
    BM25Index, build_bm25, cut_by_weight, gather_postings_batch,
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


def _totals(index, queries):
    return [sum(int(index.indptr[t + 1] - index.indptr[t])
                for t in set(index.query_term_ids(q))) for q in queries]


def _uncut(index, query):
    """The verbatim gather of one query at a budget it fits: its postings
    in gather order."""
    total = _totals(index, [query])[0]
    ids, w = index.gather_postings([query], max(total, 1))
    return ids[0, :total], w[0, :total]


def _budget(index, queries, cap, lo):
    return _pad_pow2(index.postings_budget(queries, cap=cap), lo)


def _want(index, queries, cap, lo):
    """``(budget, ids, weights, truncated, ties)``: each query's uncut
    gather cut by ``cut_by_weight``, padded as the gather pads."""
    budget = _budget(index, queries, cap, lo)
    ids = np.full((len(queries), budget), index.n_docs, np.int32)
    w = np.zeros((len(queries), budget), np.float32)
    truncated = ties = 0
    for qi, query in enumerate(queries):
        row_ids, row_w = _uncut(index, query)
        if len(row_w) > budget:
            truncated += 1
            c = np.sort(row_w)[::-1][budget - 1]
            ties += int(np.count_nonzero(row_w >= c) > budget)
        keep = cut_by_weight(row_w, budget)
        ids[qi, :len(keep)] = row_ids[keep]
        w[qi, :len(keep)] = row_w[keep]
    return budget, ids, w, truncated, ties


def _pairs(ids, w):
    return sorted(zip(ids.tolist(), w.tolist()))


def _assert_verbatim_tie_aware(index, queries, got):
    """The served rows against ``BM25Index.gather_postings`` at the same
    budget, under the tie-aware predicate; returns the rows whose cut a
    group of equal weights straddles."""
    budget = got.budget
    v_ids, v_w = index.gather_postings(queries, budget)
    straddled = 0
    for qi, query in enumerate(queries):
        row_ids, row_w = _uncut(index, query)
        if len(row_w) <= budget:
            assert got.ids[qi].tobytes() == v_ids[qi].tobytes()
            assert got.weights[qi].tobytes() == v_w[qi].tobytes()
            continue
        c = np.sort(row_w)[::-1][budget - 1]
        g_ids, g_w, vi, vw = got.ids[qi], got.weights[qi], v_ids[qi], v_w[qi]
        assert _pairs(g_ids[g_w > c], g_w[g_w > c]) == \
            _pairs(vi[vw > c], vw[vw > c])
        assert np.count_nonzero(g_w == c) == np.count_nonzero(vw == c)
        assert not (g_w < c).any() and not (vw < c).any()
        at_c = set(row_ids[row_w == c].tolist())
        assert set(g_ids[g_w == c].tolist()) <= at_c
        if np.count_nonzero(row_w >= c) == budget:
            assert _pairs(g_ids, g_w) == _pairs(vi, vw)
        else:
            straddled += 1
    return straddled


def _assert_served(index, queries, cap=CAP, lo=8):
    """The native rows equal ``cut_by_weight``'s bit for bit and the
    verbatim gather's under the tie-aware predicate."""
    budget, ids, w, truncated, ties = _want(index, queries, cap, lo)
    got = gather_postings_batch(index, queries, cap=cap, lo=lo)
    assert got.impl == "native-cpp"
    assert got.budget == budget
    assert got.ids.dtype == np.int32 and got.weights.dtype == np.float32
    assert got.ids.shape == got.weights.shape == (len(queries), budget)
    assert got.ids.tobytes() == ids.tobytes()
    assert got.weights.tobytes() == w.tobytes()
    assert (got.truncated, got.ties) == (truncated, ties)
    assert (got.cut_s > 0) == (truncated > 0)
    assert _assert_verbatim_tie_aware(index, queries, got) == ties
    return got


def _csr(lists, n_docs, vocab=None):
    """A hand-made index: term i's postings ``lists[i]`` of (doc,
    weight)."""
    indptr = np.zeros(len(lists) + 1, np.int64)
    indptr[1:] = np.cumsum([len(p) for p in lists])
    flat = [pw for p in lists for pw in p]
    return _index(indptr, np.array([d for d, _ in flat], np.int32),
                  np.array([w for _, w in flat], np.float32), n_docs, vocab)


def _index(indptr, doc_ids, weights, n_docs, vocab=None):
    n_terms = len(indptr) - 1
    return BM25Index(
        vocab=vocab or {f"t{i}": i for i in range(n_terms)},
        indptr=np.asarray(indptr, np.int64),
        doc_ids=np.asarray(doc_ids, np.int32).reshape(-1),
        weights=np.asarray(weights, np.float32).reshape(-1),
        idf=np.ones(n_terms, np.float32),
        doc_len=np.ones(n_docs, np.int32), n_docs=n_docs, avgdl=1.0,
        k1=1.5, b=0.75, epsilon=0.25)


def _tied_index(rng, n_docs, lens, values):
    """Terms of random docs whose weights come from a few values, so that
    groups of equal weights straddle every cut."""
    lists = [[(int(d), float(w)) for d, w in zip(
        np.sort(rng.permutation(n_docs)[:n]), rng.choice(values, n))]
        for n in lens]
    return _csr(lists, n_docs)


@pytest.mark.parametrize(
    "cap,lo", [(CAP, 8), (512, 8), (64, 8), (None, 8), (None, 64)],
    ids=["131072", "512", "64", "uncapped", "uncapped-lo64"])
def test_search64_batches_equal_the_verbatim_gather(legal, cap, lo):
    """Every batch at the served cap (no cut: byte for byte), at caps
    that cut most queries by weight, and with no cap at the floors of the
    evaluation's BM25 ranking (8) and of ``bench.bench_inputs`` (64)."""
    index, batches = legal
    truncated = 0
    for batch in batches:
        got = _assert_served(index, batch, cap, lo)
        truncated += got.truncated
    assert (truncated == 0) == (cap in (CAP, None))


@pytest.mark.parametrize("q", [1, 8, 64])
def test_batch_sizes(legal, q):
    index, batches = legal
    _assert_served(index, batches[1][:q])
    _assert_served(index, batches[2][:q], cap=16)


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
    got = _assert_served(index, queries + [""] * 8)
    assert (got.ids[3:6] == index.n_docs).all()
    assert (got.weights[3:6] == 0).all()
    _assert_served(index, queries, cap=8)


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
        got = _assert_served(index, queries, cap)
        totals = _totals(index, queries)
        assert got.truncated == sum(t > got.budget for t in totals)
    assert gather_postings_batch(index, ["t0 t2 t3"], cap=16).truncated == 0
    assert gather_postings_batch(index, ["t4"], cap=8).truncated == 1


def test_equal_weights_at_the_cut_fall_as_argpartition_chooses():
    """Many postings of one weight across the cut: the rule, not the
    selection algorithm, decides, so the kept postings of weight ``c``
    are the first in gather order and the row keeps gather order (the
    verbatim copy's ``np.argpartition`` keeps as many of them, chosen by
    its introselect, which is the one departure)."""
    rng = np.random.default_rng(7)
    index = _tied_index(rng, 300, (120, 90, 200, 60), [0.5, 1.0, 1.0, 2.0])
    queries = ["t0 t1", "t2 t3 t0", "t1 t1 t3", "t3", "t2 t2 t0 t1 t3"]
    for cap in (8, 32, 64, 100, 128):
        got = _assert_served(index, queries, cap)
        assert got.truncated > 0 and got.ties > 0
        for qi, query in enumerate(queries):
            row_ids, row_w = _uncut(index, query)
            if len(row_w) <= got.budget:
                continue
            # a cut row is full, and is its uncut row's first postings
            # above c and at c, in gather order
            c = np.sort(row_w)[::-1][got.budget - 1]
            quota = got.budget - np.count_nonzero(row_w > c)
            kept = (row_w > c) | ((row_w == c)
                                  & (np.cumsum(row_w == c) <= quota))
            assert got.ids[qi].tolist() == row_ids[kept].tolist()
            assert got.weights[qi].tolist() == row_w[kept].tolist()


@pytest.mark.parametrize("w,budget,kept", [
    ([1, 3, 2, 3, 2, 2, 1], 4, [1, 2, 3, 4]),     # two of three 2s fit
    ([1, 3, 2, 3, 2, 2, 1], 5, [1, 2, 3, 4, 5]),  # every 2 fits
    ([2, 2, 2, 2, 2], 3, [0, 1, 2]),               # all equal
    ([0.5, 0.0, 4.0], 8, [0, 1, 2]),               # nothing to cut
    ([0.0, -0.0, 0.0, 1.0], 2, [0, 3]),            # -0.0 equals 0.0
    ([], 8, []),
], ids=["straddle", "exact", "all-equal", "fits", "zeros", "empty"])
def test_cut_by_weight_by_hand(w, budget, kept):
    assert cut_by_weight(np.array(w, np.float32), budget).tolist() == kept


@pytest.mark.parametrize("bad", [-1.0, float("nan")])
def test_negative_or_nan_weights_raise(bad):
    with pytest.raises(ValueError):
        cut_by_weight(np.array([1.0, bad, 2.0], np.float32), 2)
    index = _csr([[(d, 1.0) for d in range(20)] + [(20, bad)]], n_docs=21)
    with pytest.raises(ValueError):
        gather_postings_batch(index, ["t0"], cap=8)
    # a row that fits is not cut, and is gathered as the verbatim gather
    # gathers it
    got = gather_postings_batch(index, ["t0"], cap=64)
    ids, w = index.gather_postings(["t0"], got.budget)
    assert got.truncated == 0
    assert (got.ids.tobytes(), got.weights.tobytes()) == \
        (ids.tobytes(), w.tobytes())


@pytest.mark.parametrize("case", [
    "ties", "all-equal", "multiplicities", "zeros", "long-rows",
    "unrepresentative",
])
def test_rows_follow_the_rule(case):
    """Rows of many postings, so that a sample of the row sets the
    candidates' threshold: heavy ties, one weight everywhere, terms
    repeated in a query, a cut at weight 0 among 0.0 and -0.0, long rows
    of distinct weights, and a row whose sample sees only its heaviest
    postings, so that the threshold admits fewer than the budget and the
    candidates are taken again."""
    rng = np.random.default_rng(len(case))
    if case == "unrepresentative":
        n = 64 * 600
        w = np.where(np.arange(n) % 64 == 0, 10.0, 1.0)
        index = _index([0, n], np.arange(n), w, n)
        queries, caps = ["t0"], (512, 1024, 8192)
    elif case == "long-rows":
        indptr = [0, 50_000, 90_000, 91_000]
        index = _index(indptr, np.concatenate(
            [rng.permutation(60_000)[:n] for n in (50_000, 40_000, 1000)]),
            rng.random(91_000).astype(np.float32) * 4, 60_000)
        queries, caps = ["t0 t1 t2", "t2 t1", "t1", "t0 t2 t2"], \
            (4096, 32768, 65536)
    else:
        values = {"ties": [0.25, 0.5, 0.5, 0.75, 1.0, 1.0, 1.0, 2.0],
                  "all-equal": [1.5],
                  "multiplicities": [0.1, 0.2, 0.3, 0.6],
                  "zeros": [0.0, -0.0, 0.0, 0.25]}[case]
        index = _tied_index(rng, 20_000, (15_000, 9_000, 4_000, 800),
                            values)
        queries = ["t0 t1 t2 t3", "t1 t1 t3", "t3 t2 t2 t2", "t0", "t3 t3",
                   "t2 t0 t0 t1"]
        caps = (8, 512, 4096, 16384)
    for cap in caps:
        got = _assert_served(index, queries, cap)
        assert got.truncated > 0
        if case in ("ties", "all-equal", "zeros"):
            assert got.ties > 0


def test_reported_totals_and_spill_check(legal):
    """The native call reports each query's total and which rows it cut;
    arguments that do not fit the index raise before the call, and a row
    past the budget with a negative weight raises instead of being
    cut."""
    index, batches = legal
    batch = batches[3][:16]
    counts = [dict.fromkeys(index.query_term_ids(q), 0) for q in batch]
    for q, c in zip(batch, counts):
        for t in index.query_term_ids(q):
            c[t] += 1
    terms = np.array([t for c in counts for t in c], np.int64)
    mult = np.array([m for c in counts for m in c.values()], np.float32)
    offsets = np.cumsum([0] + [len(c) for c in counts])
    args = (index.indptr, index.doc_ids, index.weights, index.n_docs)
    *_, totals, cut, cut_s = native_ext.gather_postings(
        terms, mult, offsets, *args, 1 << 20)
    assert totals.tolist() == _totals(index, batch)
    assert cut.tolist() == [0] * len(batch) and cut_s == 0.0
    *_, totals8, cut8, _ = native_ext.gather_postings(
        terms, mult, offsets, *args, 8)
    assert totals8.tolist() == totals.tolist()
    assert ((cut8 > 0) == (totals > 8)).all()
    with pytest.raises(ValueError):
        native_ext.gather_postings(terms + len(index.indptr), mult, offsets,
                                   *args, 8)
    with pytest.raises(ValueError):
        native_ext.gather_postings(terms, mult[:-1], offsets, *args, 8)
    with pytest.raises(ValueError):
        native_ext.gather_postings(terms, -mult, offsets, *args, 8)


def test_sixteen_threads_at_once(legal):
    index, batches = legal
    rng = np.random.default_rng(3)
    tied = _tied_index(rng, 20_000, (15_000, 9_000, 4_000),
                       [0.25, 0.5, 0.5, 1.0])
    work = [(index, b, cap) for b in batches for cap in (CAP, 256)]
    work += [(tied, ["t0 t1 t2", "t1 t2", "t2 t2 t0"], cap)
             for cap in (64, 1024, 8192)]
    work *= 2
    want = [_want(ix, b, cap, 8) for ix, b, cap in work]
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(
            lambda a: gather_postings_batch(a[0], a[1], cap=a[2]), work))
    for (budget, ids, w, truncated, ties), g in zip(want, got):
        assert g.budget == budget
        assert (g.truncated, g.ties) == (truncated, ties)
        assert g.ids.tobytes() == ids.tobytes()
        assert g.weights.tobytes() == w.tobytes()


def test_python_path_where_the_library_is_missing(legal, monkeypatch):
    """The numpy path gives the native path's arrays and counts, on the
    legal corpus's batches and on rows with heavy ties, cut and not."""
    index, batches = legal
    tied = _tied_index(np.random.default_rng(5), 5000, (4000, 2500, 700),
                       [0.5, 1.0, 1.0, 3.0])
    cases = [(ix, b, cap) for cap in (64, CAP) for ix, b in (
        (index, batches[0]), (tied, ["t0 t1 t2", "t2 t2", "t1 t0"]))]
    native = [gather_postings_batch(ix, b, cap=cap) for ix, b, cap in cases]
    monkeypatch.setattr(native_ext, "native_available", lambda: False)
    for (ix, b, cap), n in zip(cases, native):
        got = gather_postings_batch(ix, b, cap=cap)
        assert got.impl == "python"
        assert (got.budget, got.truncated, got.ties) == \
            (n.budget, n.truncated, n.ties)
        assert got.ids.tobytes() == n.ids.tobytes()
        assert got.weights.tobytes() == n.weights.tobytes()
        assert (got.cut_s > 0) == (got.truncated > 0)


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
    before = engine.postings_counters()
    native = engine.search_batch(queries, k=5, mode=mode)
    padded = queries + [""] * 21
    _, _, _, over, ties = _want(engine.store.bm25, padded, 64, 8)
    assert over > 0
    assert engine.postings_counters() == {
        "gathers": dict(before["gathers"],
                        **{"native-cpp": before["gathers"]["native-cpp"] + 1}),
        "truncated": before["truncated"] + over,
        "cut_ties": before["cut_ties"] + ties}
    monkeypatch.setattr(native_ext, "native_available", lambda: False)
    python = engine.search_batch(queries, k=5, mode=mode)
    assert engine.postings_counters() == {
        "gathers": {"native-cpp": before["gathers"]["native-cpp"] + 1,
                    "python": before["gathers"]["python"] + 1},
        "truncated": before["truncated"] + 2 * over,
        "cut_ties": before["cut_ties"] + 2 * ties}
    assert _answers(native) == _answers(python)


def test_cut_span_and_tie_counter_move_only_on_a_cut_batch(engine):
    """``postings_cut`` (a span inside ``postings``, from the time the
    gather measured) and ``postings_cut_ties`` move on a batch that the
    cap cuts inside a group of equal weights, and stay still on a batch
    that fits."""
    bm25 = engine.store.bm25
    # function words whose 64th weight is one of a group of equal weights
    cut_batch = ["a", "shall", "the of and"]
    rare = sorted(bm25.vocab, key=lambda t: int(
        bm25.indptr[bm25.vocab[t] + 1] - bm25.indptr[bm25.vocab[t]]))
    fit_batch = [" ".join(rare[i:i + 2]) for i in range(0, 8, 2)]
    padded = cut_batch + [""] * 5
    _, _, _, over, ties = _want(bm25, padded, 64, 8)
    assert over > 0 and ties > 0
    assert _want(bm25, fit_batch + [""] * 4, 64, 8)[3] == 0

    def read():
        st = engine.timer.snapshot()
        return (st.get("postings_cut", {}).get("count", 0),
                st.get("postings_cut", {}).get("total_s", 0.0),
                st["postings"]["count"], engine.postings_counters())

    n0, s0, p0, c0 = read()
    engine.search_batch(cut_batch, k=5)
    n1, s1, p1, c1 = read()
    assert (n1, p1) == (n0 + 1, p0 + 1) and s1 > s0
    assert c1["truncated"] == c0["truncated"] + over
    assert c1["cut_ties"] == c0["cut_ties"] + ties
    engine.search_batch(fit_batch, k=5)
    n2, s2, p2, c2 = read()
    assert (n2, s2, p2) == (n1, s1, p1 + 1)
    assert (c2["truncated"], c2["cut_ties"]) == \
        (c1["truncated"], c1["cut_ties"])


def test_health_shows_the_postings_counters(engine):
    """``GET /health`` carries the gather's counters beside the stage
    latencies."""
    import asyncio
    import types

    from legal_rag_tpu_torch.server.app import HttpApp

    host = types.SimpleNamespace(engine=types.SimpleNamespace(engine=engine),
                                 status="ready", error=None, loading=False)
    engine.search_batch(["a", "shall", "the of and"], k=5)
    status, body = asyncio.run(HttpApp(host).handle("GET", "/health", {}, b""))
    assert status == 200
    assert body["postings"] == engine.postings_counters()
    assert body["postings"]["truncated"] > 0
    assert "postings_cut" in body["stage_latency"]
