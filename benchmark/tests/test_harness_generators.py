"""The generators repeat for a seed and differ across seeds."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.data import legal_corpus, weights, zipf_store
from benchmark.traffic import generator as gen

HERE = Path(__file__).resolve().parents[1]


def test_legal_chunks_repeat_and_differ():
    a = legal_corpus.legal_chunks(3, 120)
    b = legal_corpus.legal_chunks(3, 120)
    c = legal_corpus.legal_chunks(4, 120)
    assert a == b
    assert [x["text"] for x in a] != [x["text"] for x in c]
    laws = {x["metadata"]["law"] for x in a}
    assert laws == {"BNS", "BNSS", "BSA", "NALSA", "SOP"}
    subs = [x for x in a if x["metadata"]["unit_type"] == "sub_section"]
    sections = {(x["metadata"]["law"], x["metadata"]["section"]) for x in a
                if x["metadata"]["unit_type"] == "section"}
    assert subs and all((x["metadata"]["law"], x["metadata"]["section"])
                        in sections for x in subs)


def test_legal_chunks_serving_shape():
    chunks = legal_corpus.legal_chunks(0, 2620)
    assert abs(len(chunks) - 2620) <= 10
    mean = np.mean([len(c["text"].split()) for c in chunks])
    assert 70 <= mean <= 110


def test_zipf_corpus_repeats_and_differs():
    def make(seed):
        return zipf_store.zipf_corpus(seed, 500, 2000, "cpu", 1.5, 0.75, 0.25)
    a, b, c = make(1), make(1), make(2)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert np.array_equal(a["csr"]["weights"], b["csr"]["weights"])
    assert not np.array_equal(a["lengths"], c["lengths"])
    assert 8 <= a["lengths"].min() and a["lengths"].max() <= 400
    assert a["chunks"][7]["text"].split()[0] in a["words"]


def test_zipf_csr_is_okapi():
    """The CSR built on the device equals a plain count of each doc's
    term frequencies under the Okapi formula."""
    corpus = zipf_store.zipf_corpus(5, 60, 300, "cpu", 1.5, 0.75, 0.25)
    csr, toks, lens = corpus["csr"], corpus["tokens"], corpus["lengths"]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n = len(lens)
    avgdl = lens.sum() / n
    words = corpus["words"]
    for w, t in list(csr["vocab"].items())[:25]:
        rank = words.index(w)
        tf = np.array([(toks[s:s + l] == rank).sum() for s, l in zip(starts, lens)])
        df = (tf > 0).sum()
        lo, hi = csr["indptr"][t], csr["indptr"][t + 1]
        assert hi - lo == df
        assert list(csr["doc_ids"][lo:hi]) == list(np.nonzero(tf)[0])
        idf = csr["idf"][t]
        d = csr["doc_ids"][lo:hi]
        want = idf * tf[d] * 2.5 / (tf[d] + 1.5 * (0.25 + 0.75 * lens[d] / avgdl))
        np.testing.assert_allclose(csr["weights"][lo:hi], want, rtol=1e-6)


def test_weights_repeat_and_differ():
    enc = {"hidden": 16, "layers": 2, "intermediate": 32, "type_vocab_size": 2}
    a = weights.minilm_params(9, "encoder", enc, 50, "cpu", max_position=40)
    b = weights.minilm_params(9, "encoder", enc, 50, "cpu", max_position=40)
    c = weights.minilm_params(10, "encoder", enc, 50, "cpu", max_position=40)
    assert np.array_equal(a["layers"][1]["output"]["kernel"],
                          b["layers"][1]["output"]["kernel"])
    assert not np.array_equal(a["embeddings"]["word"], c["embeddings"]["word"])
    assert a["layers"][0]["intermediate"]["kernel"].shape == (16, 32)
    e = weights.unit_embeddings(9, 10, 16, "cpu")
    assert torch.allclose(e.norm(dim=1), torch.ones(10), atol=1e-6)
    assert weights.stream_seed(2 ** 31 + 5, "x") != weights.stream_seed(2 ** 31 + 6, "x")


def test_query_generators_repeat_and_differ():
    spec = json.loads((HERE / "traffic" / "query-open.json").read_text())["queries"]
    q = lambda s: gen.form_queries(spec, 40, np.random.default_rng(s))
    assert q(1) == q(1) and q(1) != q(2)
    texts, forms = q(1)
    counts = np.bincount(forms)
    assert len(set(texts)) > 8 and counts.min() == counts.max() == 5
    assert all(spec["forms"][f]["template"].split("{")[0] in t
               for t, f in zip(texts, forms))
    # every seed sends the same requests, in its own order
    assert sorted(q(2)[0]) == sorted(texts)
    chunks = legal_corpus.legal_chunks(0, 100)
    spec = {"min_words": 3, "max_words": 8}
    c = lambda s: gen.chunk_word_queries(spec, chunks, 30, np.random.default_rng(s))
    assert c(1) == c(1) and c(1) != c(2)
    assert all(3 <= len(x.split()) <= 8 for x in c(1))
    words = zipf_store.ranked_words(3000)
    spec = {"min_terms": 2, "max_terms": 5, "rank_lo": 200, "rank_hi": 3000}
    r = lambda s: gen.rare_term_queries(spec, words, 30, np.random.default_rng(s))
    assert r(1) == r(1) and r(1) != r(2)
    assert all(words.index(w) >= 199 for x in r(1) for w in x.split())


def test_schedule_same_gaps_other_order():
    a = gen.schedule(20.0, 10.0, np.random.default_rng(1))
    b = gen.schedule(20.0, 10.0, np.random.default_rng(1))
    c = gen.schedule(20.0, 10.0, np.random.default_rng(2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == 200 and a[0] == 0.0 and a[-1] < 10.0
    np.testing.assert_allclose(np.sort(np.diff(np.append(a, 10.0))),
                               np.sort(np.diff(np.append(c, 10.0))), rtol=1e-9)
