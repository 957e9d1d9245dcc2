"""The ported serving slice end to end on the CPU, against the JAX
package on one store.

A ~3,000-chunk store is built by the JAX package's ``build_index``
(with a cross-encoder checkpoint) and loaded by both packages. With
the large-N dispatch
forced down to 2,048 docs, both engines take the two-phase dense path
(the JAX side's K1 in interpret mode, the port's plain version), and
``LegalEngine.query`` must give the same orchestrated docs in the same
order and the same response payload, in process and over HTTP. Scores
compare at atol 1e-5 (fp32 in another summation order).

Also: the chip smoke's store synthesiser at 2,000 docs against
``build_bm25`` on its own texts.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest

import legal_rag_tpu.parallel.sharded as jsh
import legal_rag_tpu_torch.ops.dense as tdense
import legal_rag_tpu_torch.parallel.sharded as tsh
from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig

FORCED = 2048

CFG = RetrievalConfig(
    encoder=EncoderConfig(
        vocab_size=4000, hidden=32, layers=2, heads=4, intermediate=64,
        max_len=64, encode_batch=512,
    ),
    sharding=ShardingConfig(num_shards=1),
)

QUERIES = [
    # victim distress: 4-query expansion, narrative -> dense-union
    "I was robbed at gunpoint just now, what is the procedure and what "
    "are the rights of the victim?",
    # procedural (heading-length)
    "What is the procedure to file an FIR?",
    # short heading
    "punishment for robbery",
    # informational narrative
    "what does the law say about the rights of a person who is "
    "arrested by the police",
]

_LAWS = ("BNS", "BNSS", "BSA", "NALSA", "SOP")
_TOPICS = (
    "punishment robbery theft assault imprisonment fine",
    "procedure fir police officer information registration zero",
    "victim compensation scheme rights legal aid nalsa",
    "arrest custody bail magistrate warrant rights accused",
    "evidence witness examination court record document",
)


def _chunks(n, seed=51):
    rng = np.random.default_rng(seed)
    filler = [f"term{i}" for i in range(400)] + "the of and to a in is by".split()
    out = []
    for i in range(n):
        law = _LAWS[i % len(_LAWS)]
        topic = _TOPICS[int(rng.integers(len(_TOPICS)))].split()
        words = list(rng.choice(topic, size=int(rng.integers(4, 12))))
        words += list(rng.choice(filler, size=int(rng.integers(10, 60))))
        rng.shuffle(words)
        header = f"{law} Section {i} {' '.join(topic[:2]).title()}"
        out.append({
            "text": header + "\n\n" + " ".join(words),
            "canonical_header": header,
            "section_id": f"{law}_{i}",
            "metadata": {"law": law, "section": str(i),
                         "unit_type": "section"},
        })
    return out


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    from legal_rag_tpu.index.builder import build_index
    from legal_rag_tpu.models.cross_encoder import CrossEncoder
    from legal_rag_tpu.models.encoder import SentenceEncoder

    chunks = _chunks(3000)
    encoder = SentenceEncoder(
        cfg=CFG.encoder, vocab_corpus=[c["text"] for c in chunks],
        prefer_tokenizer="python",
    )
    store = build_index(chunks, encoder=encoder, config=CFG)
    ce = CrossEncoder(encoder, seed=3)
    to_np = lambda t: (
        {k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
        else [to_np(v) for v in t] if isinstance(t, list) else np.asarray(t)
    )
    store.ce_params = to_np(ce.params)
    store.ce_alpha = 0.5
    path = tmp_path_factory.mktemp("slice_store")
    store.save(path)
    return path


@pytest.fixture(scope="module")
def engines(store_dir):
    """(jax LegalEngine, port LegalEngine), both on the two-phase path."""
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu.retrieval.facade import LegalEngine as JaxEngine
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    mp = pytest.MonkeyPatch()
    for mod in (jsh, tsh):
        mp.setattr(mod, "TWOPHASE_MIN_DOCS", FORCED)
        mp.setattr(mod, "TWOPHASE_BLOCK_N", FORCED)
    calls = {"jax": 0, "torch": 0}
    jax_fn, torch_fn = jsh.dense_topk_twophase_rm, tdense.segmax_rm

    def jax_counting(*a, **kw):
        calls["jax"] += 1            # runs while the search traces
        return jax_fn(*a, **kw)

    def torch_counting(*a, **kw):
        calls["torch"] += 1
        return torch_fn(*a, **kw)

    mp.setattr(jsh, "dense_topk_twophase_rm", jax_counting)
    mp.setattr(tdense, "segmax_rm", torch_counting)
    jsh.sharded_hybrid_search.clear_cache()
    jax_engine = JaxEngine(store=JaxStore.load(store_dir), config=CFG,
                           use_llm=False)
    port_engine = LegalEngine(store=VectorStore.load(store_dir), config=CFG,
                              use_llm=False, device="cpu")
    assert jax_engine.engine.index.docs.shape[0] == 4096
    assert port_engine.engine.index.docs.shape[0] == 4096
    assert port_engine.orchestrator.reranker is not None
    jax_engine.twophase_calls = port_engine.twophase_calls = calls
    yield jax_engine, port_engine
    mp.undo()
    jsh.sharded_hybrid_search.clear_cache()


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax_engine(engines, query):
    jax_engine, port_engine = engines
    calls = port_engine.twophase_calls
    torch_before = calls["torch"]
    dispatches_before = getattr(port_engine.engine, "device_dispatches", 0)
    ref = jax_engine.query(query)
    got = port_engine.query(query)
    assert got == ref
    # every port search took K1's path; JAX traced it (at least once:
    # its executables are cached per shape)
    dispatches = port_engine.engine.device_dispatches - dispatches_before
    assert calls["torch"] - torch_before == dispatches >= 1
    assert calls["jax"] >= 1
    ref_o = jax_engine.orchestrator.orchestrate(query)
    got_o = port_engine.orchestrator.orchestrate(query)
    assert got_o["intent"] == ref_o["intent"]
    head = lambda rows: [r["chunk"]["canonical_header"] for r in rows]
    assert head(got_o["results"]) == head(ref_o["results"])
    for a, b in zip(got_o["results"], ref_o["results"]):
        for key in ("score", "semantic", "keyword", "rerank_score",
                    "retrieval_score"):
            assert a[key] == pytest.approx(b[key], abs=1e-5), key


def test_query_forms_cover_the_serving_path(engines):
    _, port_engine = engines
    intents = [port_engine.orchestrator.classifier.classify(q) for q in QUERIES]
    assert intents[0].user_context == "victim_distress"
    from legal_rag_tpu_torch.retrieval.query_form import is_heading, is_narrative

    assert is_narrative(QUERIES[0]) and is_narrative(QUERIES[3])
    assert is_heading(QUERIES[1]) and is_heading(QUERIES[2])
    engine = port_engine.engine
    before = engine.device_dispatches
    port_engine.query(QUERIES[0])     # primary + dense-union second call
    assert engine.device_dispatches - before == 2


def test_search_batch_matches_jax_engine(engines):
    jax_engine, port_engine = engines
    for mode in ("rrf", "weighted"):
        ref = jax_engine.engine.search_batch(QUERIES, k=7, mode=mode)
        got = port_engine.engine.search_batch(QUERIES, k=7, mode=mode)
        for a, b in zip(got, ref):
            assert [r.doc_id for r in a] == [r.doc_id for r in b]
            assert [r.score for r in a] == pytest.approx(
                [r.score for r in b], abs=1e-5)


def test_served_port_answers_with_the_jax_payload(engines):
    from legal_rag_tpu.server.app import _response_payload
    from legal_rag_tpu_torch.cli import BackgroundServer

    jax_engine, port_engine = engines
    server = BackgroundServer(port_engine)
    try:
        req = urllib.request.Request(
            f"{server.url}/api/v1/query",
            data=json.dumps({"query": QUERIES[2]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            body = json.loads(r.read())
    finally:
        server.stop()
    ref = _response_payload(jax_engine.query(QUERIES[2]))
    assert body == json.loads(json.dumps(ref))


def test_synthetic_store_matches_build_bm25():
    from legal_rag_tpu.ops.sparse import build_bm25
    from legal_rag_tpu_torch.index.synthetic import (
        planted_ids, synthesize_store,
    )
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    cfg = dataclasses.replace(CFG.encoder, vocab_size=3000)
    store = synthesize_store(2000, seed=7, planted=QUERIES[:3],
                             vocab_queries=QUERIES[3:], cfg=cfg,
                             vocab_size=6000, device="cpu")
    texts = [c["text"] for c in store.chunks]
    ref = build_bm25(texts)
    got = store.bm25
    assert got.vocab == ref.vocab
    for name in ("indptr", "doc_ids", "idf", "doc_len"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(got.weights, ref.weights)
    assert got.avgdl == ref.avgdl and got.n_docs == ref.n_docs == 2000
    lengths = ref.doc_len[np.setdiff1d(np.arange(2000), planted_ids(2000, 3))]
    assert 90 < lengths.mean() < 120
    assert all(w in ref.vocab for q in QUERIES for w in q.lower().split())
    # planted docs: the query's words, and the encoder's embedding of it
    enc = SentenceEncoder(cfg=cfg, params=store.encoder_params, device="cpu",
                          tokenizer=WordPieceTokenizer(store.wp_vocab))
    want = enc.encode(QUERIES[:3])
    for j, doc in enumerate(planted_ids(2000, 3)):
        assert store.chunks[doc]["canonical_header"] == f"PLANTED {j}"
        assert QUERIES[j].lower() in store.chunks[doc]["text"]
        np.testing.assert_allclose(store.embeddings[doc], want[j], atol=1e-6)
    norms = np.linalg.norm(store.embeddings, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert set(store.ce_params) == {"trunk", "head"}
