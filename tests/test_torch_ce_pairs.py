"""The cross-encoder's pair encoding in one C++ call
(``NativeWordPiece.encode_pairs``, ``native/wordpiece_pairs.cpp``)
against ``CrossEncoder.encode_pairs`` on the Python tokenizer: ids, mask,
segment ids and shape equal byte for byte on a synthetic corpus in the
five laws' shape against the served query forms, on the adversarial and
Unicode fuzz texts of ``test_torch_native.py``, and at the truncation
and bucket edges. Also ``score_pairs``' logits under either pair
encoder, which one a ``LegalEngine``'s reranker takes and counts, and
concurrent calls."""

import dataclasses
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from legal_rag_tpu_torch import native_ext
from legal_rag_tpu_torch.config import EncoderConfig
from legal_rag_tpu_torch.index.builder import _chunk_dicts
from legal_rag_tpu_torch.models.cross_encoder import CrossEncoder
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab,
)
from legal_rag_tpu_torch.scripts.bench_http import QUERIES
from test_torch_native import ADVERSARIAL, fuzz_texts

POOL = 16           # the served rerank's candidates a request


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    docs = tmp_path_factory.mktemp("ce_pairs_docs")
    write_legal_corpus(docs, n_chunks=200, seed=5)
    return [c["text"] for c in _chunk_dicts(parse_corpus(docs))]


@pytest.fixture(scope="module")
def toks(chunks):
    """(the Python tokenizer, the C++ one) over one vocab."""
    if not native_ext.build_native():
        pytest.skip("no C++ compiler builds the native tokenizer")
    vocab = build_wordpiece_vocab(chunks + QUERIES, size=8000, min_freq=1)
    return WordPieceTokenizer(vocab), native_ext.NativeWordPiece(vocab)


def _python_pairs(py, queries, docs, max_len):
    """``CrossEncoder.encode_pairs`` itself, on the Python tokenizer."""
    ce = types.SimpleNamespace(tokenizer=py, cfg=None)
    return CrossEncoder.encode_pairs(ce, queries, docs, max_len)


def _assert_same(toks, queries, docs, max_len):
    py, cc = toks
    want = _python_pairs(py, queries, docs, max_len)
    got = cc.encode_pairs(queries, docs, max_len)
    for w, g, name in zip(want, got, ("ids", "mask", "token types")):
        assert g.dtype == w.dtype == np.int32, name
        assert g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    return got


@pytest.mark.parametrize("max_len", [64, 256])
def test_corpus_against_the_served_forms(toks, chunks, max_len):
    """Each form against every chunk, a pool of 16 at a time, the query
    repeated as the orchestrator sends it."""
    for q in QUERIES:
        for lo in range(0, len(chunks), POOL):
            docs = chunks[lo:lo + POOL]
            _assert_same(toks, [q] * len(docs), docs, max_len)


@pytest.mark.parametrize("case", ["adversarial", "fuzz"])
@pytest.mark.parametrize("max_len", [64, 256])
def test_unicode_texts_as_queries_and_documents(toks, case, max_len):
    texts = ADVERSARIAL if case == "adversarial" else fuzz_texts()
    rolled = texts[1:] + texts[:1]
    _assert_same(toks, texts, rolled, max_len)
    _assert_same(toks, rolled, texts, max_len)


@pytest.mark.parametrize("max_len", [64, 256])
def test_truncation_edges(toks, chunks, max_len):
    """A query past its budget of ``max_len // 2 - 2`` pieces, a
    document past what the query leaves, an empty query and an empty
    document."""
    long_q = " ".join(chunks[:3])
    long_d = " ".join(chunks[3:8])
    ids, mask, tt = _assert_same(
        toks, [long_q, "robbery", "", ""], [long_d, long_d, "theft", ""],
        max_len)
    assert ids.shape == (4, max_len)
    # the long query kept its budget, the document the rest
    assert (tt[0][mask[0] > 0] == 0).sum() == max_len // 2
    assert mask[0].sum() == max_len


@pytest.mark.parametrize("max_len", [64, 256])
def test_one_pair_and_a_short_batch(toks, chunks, max_len):
    """B = 1 at the corpus' length, and a batch whose longest pair is
    under 32 pieces (the bucket's floor)."""
    _assert_same(toks, [QUERIES[2]], [chunks[0]], max_len)
    ids, _, _ = _assert_same(toks, ["theft", "FIR"], ["robbery", "bail"],
                             max_len)
    assert ids.shape == (2, 32)


@pytest.mark.parametrize("max_len", [64, 256])
def test_distinct_queries_in_one_call(toks, chunks, max_len):
    """Queries that change from pair to pair, and return to an earlier
    one: each pair keeps its own query's pieces."""
    queries = [QUERIES[i % 3] for i in range(POOL)] + [QUERIES[0]] * 4
    _assert_same(toks, queries, chunks[:len(queries)], max_len)


@pytest.mark.parametrize("max_len", [1, 2, 3, 5, 31])
def test_lengths_below_the_bucket_floor(toks, chunks, max_len):
    """The Python slices' arithmetic where the query's budget is
    negative or nothing, and rows cut to ``max_len``."""
    _assert_same(toks, QUERIES[:4], chunks[:4], max_len)


def test_no_pairs_and_a_bad_length(toks):
    _assert_same(toks, [], [], 256)
    with pytest.raises(ValueError):
        toks[1].encode_pairs(["q"], ["d"], 0)


CE_CFG = EncoderConfig(hidden=32, layers=1, heads=4, intermediate=64,
                       max_len=64)


def _cross_encoders(toks, seed=3):
    """Two cross-encoders on one trunk and head: one on an encoder that
    took the C++ tokenizer, one on an encoder that did not."""
    py, _ = toks
    cfg = dataclasses.replace(CE_CFG, vocab_size=len(py.vocab))
    native = SentenceEncoder(cfg=cfg, tokenizer=py, prefer_tokenizer="auto",
                             device="cpu")
    python = SentenceEncoder(cfg=cfg, tokenizer=py, params=native.params,
                             prefer_tokenizer="python", device="cpu")
    assert (native.tokenizer_impl, python.tokenizer_impl) == \
        ("native-cpp", "python")
    return CrossEncoder(native, seed=seed), CrossEncoder(python, seed=seed)


def test_score_pairs_logits_equal_under_either_pair_encoder(toks, chunks):
    cc, py = _cross_encoders(toks)
    assert (cc.pair_encoder_impl, py.pair_encoder_impl) == \
        ("native-cpp", "python")
    for q in QUERIES:
        docs = chunks[:POOL]
        a = cc.score_pairs([q] * POOL, docs)
        b = py.score_pairs([q] * POOL, docs)
        assert a.tobytes() == b.tobytes(), q
    assert cc.pair_encodes == {"native-cpp": len(QUERIES), "python": 0}
    assert py.pair_encodes == {"native-cpp": 0, "python": len(QUERIES)}


def test_concurrent_score_pairs_count_every_call(toks, chunks):
    """Many threads through one cross-encoder with a short switch
    interval: every call's logits are its own and the count loses no
    call."""
    cc, _ = _cross_encoders(toks)
    work = [(QUERIES[i % len(QUERIES)], chunks[i % 40:i % 40 + 4])
            for i in range(160)]
    want = [cc.score_pairs([q] * len(d), d) for q, d in work]
    cc.pair_encodes["native-cpp"] = 0
    cc.timer.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futures = [pool.submit(cc.score_pairs, [q] * len(d), d)
                       for q, d in work]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert cc.pair_encodes["native-cpp"] == len(work)
    snap = cc.timer.snapshot()
    assert snap["ce_tokenize"]["count"] == snap["ce"]["count"] == len(work)


# -- the served engine's choice ---------------------------------------------

ENGINE_QUERIES = [
    "What is the punishment for robbery under BNS?",
    "I was robbed at gunpoint just now, what do I do?",
]


@pytest.fixture(scope="module")
def store():
    from legal_rag_tpu_torch.index.synthetic import synthesize_store

    cfg = EncoderConfig(hidden=96, layers=1, heads=4, intermediate=96,
                        max_len=32)
    return synthesize_store(300, seed=4, planted=ENGINE_QUERIES[:1], cfg=cfg,
                            vocab_size=2000, device="cpu")


@pytest.mark.parametrize("impl", ["native-cpp", "python"])
def test_engine_reranker_takes_the_pinned_pair_encoder(store, monkeypatch,
                                                       impl):
    """A ``LegalEngine`` whose store pinned the C++ tokenizer counts its
    ``score_pairs`` calls as ``native-cpp`` and never calls
    ``encode_pairs``; one pinned to ``python`` counts them as ``python``
    through ``encode_pairs``."""
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    if impl == "native-cpp" and not native_ext.build_native():
        pytest.skip("no C++ compiler builds the native tokenizer")
    pinned = dataclasses.replace(
        store, encoder_info={**store.encoder_info, "tokenizer_impl": impl})
    legal = LegalEngine(store=pinned, use_llm=False, device="cpu",
                        rerank=True)
    assert legal.engine.encoder.tokenizer_impl == impl
    ce = legal.orchestrator.reranker
    assert ce.pair_encoder_impl == impl
    verbatim = ce.encode_pairs
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return verbatim(*args, **kwargs)

    monkeypatch.setattr(ce, "encode_pairs", spy)
    for q in ENGINE_QUERIES:
        legal.query(q, k=5)
    n = legal.timer.snapshot()["ce"]["count"]
    assert n == len(ENGINE_QUERIES)
    other = "python" if impl == "native-cpp" else "native-cpp"
    assert ce.pair_encodes == {impl: n, other: 0}
    assert len(calls) == (n if impl == "python" else 0)
