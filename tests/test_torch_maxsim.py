"""MaxSim late interaction (both served modes): the port against the JAX
package on the same numpy-seeded inputs.

- ``maxsim_topk`` and ``maxsim_rescore`` (fp32 and bf16; a duplicate
  doc, a doc with no tokens, padded query tokens, n_valid < N, invalid
  and duplicate candidates, C < k), ``MultiVectorIndex`` packing and
  ``minilm_token_and_pooled`` at a tiny MiniLM;
- the dense-first rerank with full coverage equal to the full scan;
- both engine modes over a store the JAX builder made with
  ``build_index(..., multi_vector=12)``, port engine against JAX engine,
  and the port's server: 200 on both modes, 422 on a slab-less store
  and for maxsim-rerank on a quantized tier.

Tolerance: scores within 1e-5 x (the query's real tokens), absolute
(each token adds one fp32 max of sums in another order); ids equal
under the tie-aware rule of tests/test_dense.py ``assert_topk_equiv``
with that band, against a float64 MaxSim over the same (bf16-rounded)
values. GPU-marked cases compare the card with the CPU and skip here.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig
from legal_rag_tpu.ops.maxsim import (
    MultiVectorIndex as JaxMultiVectorIndex,
    maxsim_rescore as jax_maxsim_rescore,
    maxsim_topk as jax_maxsim_topk,
    minilm_token_and_pooled as jax_token_and_pooled,
)
from legal_rag_tpu_torch.ops.maxsim import (
    MultiVectorIndex, MultiVectorSearcher, maxsim_rescore, maxsim_topk,
    minilm_token_and_pooled,
)

TOL = 1e-5          # a real query token's share of the score tolerance
TD = 12

TINY_CFG = RetrievalConfig(
    encoder=EncoderConfig(
        vocab_size=4000, hidden=32, layers=2, heads=4,
        intermediate=64, max_len=64, encode_batch=16,
    ),
    sharding=ShardingConfig(num_shards=1),
)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def golden_maxsim(q_tokens, q_mask, doc_tokens, doc_mask):
    """float64 MaxSim ``[Q, N]`` of (already dtype-rounded) arrays."""
    sims = np.einsum("qtd,nsd->qtns", q_tokens.astype(np.float64),
                     doc_tokens.astype(np.float64))
    sims = np.where(doc_mask[None, None] > 0, sims, -np.inf)
    best = sims.max(axis=3)
    best = np.where(np.isfinite(best), best, 0.0)
    return (best * (q_mask[:, :, None] > 0)).sum(axis=1)


def assert_topk_equiv_scores(s64, got_s, got_i, tol):
    """The tie-aware rule (tests/test_dense.py) against given float64
    scores ``s64 [Q, N]``, with a per-query band ``tol [Q]``: values
    rank by rank, each id's own score, order, every id clearly above
    the k-th present, none clearly below it."""
    got_s = np.asarray(got_s, np.float64)
    got_i = np.asarray(got_i)
    k = got_i.shape[1]
    for qi in range(s64.shape[0]):
        srt = np.sort(s64[qi])[::-1]
        kth = srt[k - 1]
        np.testing.assert_allclose(got_s[qi], srt[:k], rtol=0, atol=tol[qi])
        assert (np.diff(got_s[qi]) <= tol[qi]).all()
        got_true = s64[qi, got_i[qi]]
        np.testing.assert_allclose(got_s[qi], got_true, rtol=0, atol=tol[qi])
        must = np.where(s64[qi] > kth + tol[qi])[0]
        assert set(must) <= set(got_i[qi].tolist())
        assert (got_true >= kth - tol[qi]).all()
        assert len(set(got_i[qi].tolist())) == k


def assert_equal_under_ties(got, ref, s64, tol):
    """Two ``(scores, ids)`` results: scores rank by rank within ``tol``;
    where ids differ, both docs score alike in float64 (a tie)."""
    (gs, gi), (rs, ri) = got, ref
    gs, gi, rs, ri = (np.asarray(x) for x in (gs, gi, rs, ri))
    np.testing.assert_allclose(gs, rs, rtol=0, atol=float(np.max(tol)))
    for qi, rank in zip(*np.nonzero(gi != ri)):
        a, b = gi[qi, rank], ri[qi, rank]
        assert a >= 0 and b >= 0, (qi, rank, a, b)
        assert abs(s64[qi, a] - s64[qi, b]) <= tol[qi], (qi, rank, a, b)


@pytest.fixture(scope="module")
def data():
    """300 docs of 8 token slots, 3 queries of 5 token slots, D=16: doc
    150 duplicates doc 7, doc 20 has no tokens, query 1 pads 2 slots."""
    rng = np.random.default_rng(3)
    n, td, tq, d = 300, 8, 5, 16
    doc_tokens = rng.standard_normal((n, td, d)).astype(np.float32)
    doc_mask = (rng.random((n, td)) > 0.3).astype(np.int32)
    doc_mask[:, 0] = 1
    doc_tokens[150], doc_mask[150] = doc_tokens[7], doc_mask[7]
    doc_mask[20] = 0
    doc_tokens *= doc_mask[:, :, None]
    q_tokens = rng.standard_normal((3, tq, d)).astype(np.float32)
    # query 2 aims at doc 7 (and its duplicate), so they tie at the top
    q_tokens[2] = doc_tokens[7, :tq] + 0.05 * q_tokens[2]
    q_mask = np.ones((3, tq), dtype=np.int32)
    q_mask[1, 3:] = 0
    return q_tokens, q_mask, doc_tokens, doc_mask


def _rounded(x, dtype):
    """``x`` as the dtype holds it, back in float32 numpy."""
    return torch.from_numpy(x).to(DTYPES[dtype][0]).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [None, 290])
def test_maxsim_topk_matches_jax(data, dtype, n_valid):
    q_tokens, q_mask, doc_tokens, doc_mask = data
    tdt, jdt = DTYPES[dtype]
    k = 10
    ref = jax_maxsim_topk(
        jnp.asarray(q_tokens, jdt), jnp.asarray(q_mask),
        jnp.asarray(doc_tokens, jdt), jnp.asarray(doc_mask), k=k,
        block_n=128, n_valid=None if n_valid is None else jnp.int32(n_valid),
    )
    got = maxsim_topk(
        torch.from_numpy(q_tokens).to(tdt), torch.from_numpy(q_mask),
        torch.from_numpy(doc_tokens).to(tdt), torch.from_numpy(doc_mask),
        k, block_n=128, n_valid=n_valid,
    )
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    s64 = golden_maxsim(_rounded(q_tokens, dtype), q_mask,
                        _rounded(doc_tokens, dtype), doc_mask)
    s64[:, doc_tokens.shape[0] if n_valid is None else n_valid:] = -np.inf
    tol = TOL * q_mask.sum(axis=1)
    assert_topk_equiv_scores(s64, got[0].numpy(), got[1].numpy(), tol)
    assert_equal_under_ties(got, ref, s64, tol)
    # the duplicate pair ties exactly; the lower id comes first
    ids = got[1].numpy()[2].tolist()
    assert ids[:2] == [7, 150]
    assert got[0][2, 0] == got[0][2, 1]


def test_maxsim_topk_block_size_does_not_matter(data):
    q_tokens, q_mask, doc_tokens, doc_mask = (torch.from_numpy(x) for x in data)
    runs = [maxsim_topk(q_tokens, q_mask, doc_tokens, doc_mask, 300,
                        block_n=b) for b in (7, 64, 512)]
    tol = TOL * float(q_mask.sum(dim=1).max())
    for s, i in runs[1:]:
        torch.testing.assert_close(s, runs[0][0], rtol=0, atol=tol)
        assert torch.equal(i, runs[0][1])
    # the doc with no tokens competes with a score of 0
    s, i = runs[0]
    for qi in range(3):
        assert s[qi, i[qi].tolist().index(20)] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [8, 16])
def test_maxsim_rescore_matches_jax(data, dtype, k):
    """Invalid candidates (-1, N, >= n_valid) and a repeated padding id
    sink last as (-inf, -1); duplicate valid ids stay; C=12 < k=16
    pads."""
    q_tokens, q_mask, doc_tokens, doc_mask = data
    tdt, jdt = DTYPES[dtype]
    n_valid = 290
    cand = np.array([
        [7, 150, 3, -1, 300, 295, 42, 42, 20, 11, 299, 5],
        [-1, -1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
        [150, 7, 100, 200, 20, -5, 289, 290, 0, 1, 2, 3],
    ], dtype=np.int32)
    ref = jax_maxsim_rescore(
        jnp.asarray(q_tokens, jdt), jnp.asarray(q_mask),
        jnp.asarray(doc_tokens, jdt), jnp.asarray(doc_mask),
        jnp.asarray(cand), k=k, n_valid=jnp.int32(n_valid),
    )
    got = maxsim_rescore(
        torch.from_numpy(q_tokens).to(tdt), torch.from_numpy(q_mask),
        torch.from_numpy(doc_tokens).to(tdt), torch.from_numpy(doc_mask),
        torch.from_numpy(cand), k, n_valid=n_valid,
    )
    gs, gi = got[0].numpy(), got[1].numpy()
    rs, ri = np.asarray(ref[0]), np.asarray(ref[1])
    assert gs.shape == gi.shape == (3, k)
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(rs))
    np.testing.assert_array_equal(gi[~np.isfinite(gs)], -1)
    np.testing.assert_array_equal(gi, ri)
    fin = np.isfinite(rs)
    tol = TOL * q_mask.sum(axis=1)
    np.testing.assert_allclose(gs[fin], rs[fin], rtol=0, atol=tol.max())
    s64 = golden_maxsim(_rounded(q_tokens, dtype), q_mask,
                        _rounded(doc_tokens, dtype), doc_mask)
    for qi in range(3):
        valid = [c for c in cand[qi].tolist() if 0 <= c < n_valid]
        want = sorted(valid, key=lambda c: (-s64[qi, c], c))[:k]
        assert gi[qi, :len(want)].tolist() == want
        assert (gi[qi, len(want):] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_vector_index_packs_like_jax(dtype):
    rng = np.random.default_rng(5)
    lens = [3, 9, 1, 6, 12, 4]
    embs = [rng.standard_normal((t, 16)).astype(np.float32) * 3 for t in lens]
    ref = JaxMultiVectorIndex.from_token_embeddings(embs, token_budget=8,
                                                    dtype=dtype)
    got = MultiVectorIndex.from_token_embeddings(embs, token_budget=8,
                                                 dtype=dtype, device="cpu")
    assert got.n_docs == ref.n_docs == 6
    assert got.doc_tokens.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(got.doc_tokens.float().numpy(),
                                  np.asarray(ref.doc_tokens, np.float32))
    np.testing.assert_array_equal(got.doc_mask.numpy(),
                                  np.asarray(ref.doc_mask))
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    qm = np.ones((2, 4), np.int32)
    rs, ri = ref.search(q, qm, k=6, block_n=4)
    gs, gi = got.search(q, qm, k=6, block_n=4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=0,
                               atol=4 * TOL)


@pytest.fixture(scope="module")
def tiny_minilm():
    from legal_rag_tpu_torch.index.synthetic import random_minilm_params
    from legal_rag_tpu_torch.models import convert
    from legal_rag_tpu_torch.models.minilm import MiniLM

    rng = np.random.default_rng(13)
    params = random_minilm_params(rng, TINY_CFG.encoder, vocab_size=200,
                                  max_position=64)
    for layer in params["layers"]:
        layer["intermediate"]["bias"] = (
            0.1 * rng.standard_normal(TINY_CFG.encoder.intermediate)
        ).astype(np.float32)
    model = MiniLM.from_state_dict(
        TINY_CFG.encoder, convert.minilm_state_dict_from_jax(params))
    ids = rng.integers(5, 200, (4, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < np.array([12, 7, 2, 10])[:, None])
    mask = mask.astype(np.int32)
    return params, model, np.where(mask == 1, ids, 0).astype(np.int32), mask


def test_minilm_token_and_pooled_matches_jax(tiny_minilm):
    params, model, ids, mask = tiny_minilm
    r_tok, r_pool = jax_token_and_pooled(
        params, jnp.asarray(ids), jnp.asarray(mask), TINY_CFG.encoder)
    with torch.inference_mode():
        tok, pool = minilm_token_and_pooled(
            model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(tok.numpy(), np.asarray(r_tok), atol=1e-5)
    np.testing.assert_allclose(pool.numpy(), np.asarray(r_pool), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(pool.numpy(), axis=1), 1.0,
                               atol=1e-6)


# -- a JAX-built multi-vector store, served by both packages ---------------


@pytest.fixture(scope="module")
def mv_store_dir(corpus_texts, tmp_path_factory):
    from legal_rag_tpu.index.builder import build_index

    chunks = [{
        "text": t,
        "metadata": {"law": "TEST", "section": str(i), "unit_type": "section"},
        "canonical_header": f"TEST Section {i}",
        "section_id": f"TEST_{i}",
    } for i, t in enumerate(corpus_texts)]
    store = build_index(chunks, config=TINY_CFG, multi_vector=TD)
    path = tmp_path_factory.mktemp("mv_store")
    store.save(path)
    return path


@pytest.fixture(scope="module")
def engines(mv_store_dir):
    """(JAX RetrievalEngine, port RetrievalEngine on the CPU)."""
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    return (JaxEngine(JaxStore.load(mv_store_dir), config=TINY_CFG),
            RetrievalEngine(VectorStore.load(mv_store_dir), config=TINY_CFG,
                            device="cpu"))


def _queries(corpus_texts):
    # self-retrieval (the longer texts overrun Td=12 and truncate), and
    # two free-form queries
    return [corpus_texts[i] for i in (10, 33, 61)] + ["police fir",
                                                      "the w3 of w17"]


def _rows(rows):
    k = max(len(r) for r in rows)
    s = np.full((len(rows), k), -np.inf)
    i = np.full((len(rows), k), -1)
    for qi, row in enumerate(rows):
        s[qi, :len(row)] = [r.score for r in row]
        i[qi, :len(row)] = [r.doc_id for r in row]
    return s, i


def _engine_golden(engine, queries, q_tok=None):
    """float64 MaxSim of bf16 query tokens (by default the port engine's
    own) over the engine's bf16 slab, and each query's real tokens."""
    tok, q_mask, _ = engine._encode_query_tokens(queries)
    q_tok = tok if q_tok is None else torch.tensor(np.asarray(q_tok))
    mv = engine.mv_index
    s64 = golden_maxsim(q_tok.to(torch.bfloat16).float().numpy(), q_mask,
                        mv.doc_tokens.full().float().numpy(),
                        mv.doc_mask.numpy())
    return s64[:, :engine.store.n_docs], q_mask.sum(axis=1)


def test_query_tokens_match_jax_engine(engines, corpus_texts):
    jax_engine, port_engine = engines
    queries = _queries(corpus_texts)
    r_tok, r_mask, r_pool = jax_engine._encode_query_tokens(queries)
    tok, mask, pool = port_engine._encode_query_tokens(queries)
    np.testing.assert_array_equal(mask, np.asarray(r_mask))
    assert tok.shape == (len(queries), TD, port_engine.store.dim)
    np.testing.assert_allclose(tok.numpy(), np.asarray(r_tok), atol=1e-5)
    np.testing.assert_allclose(pool.numpy(), np.asarray(r_pool), atol=1e-5)


@pytest.mark.parametrize("mode", ["maxsim", "maxsim-rerank"])
def test_engine_mode_matches_jax_engine(engines, corpus_texts, mode):
    """Each engine ranks exactly for its own query tokens (1e-5 x
    tokens against float64), and the two agree under ties. Both cast
    the query tokens to the slab's bf16; fp32 states ~1e-7 apart (the
    two frameworks' summation orders) can round to neighbouring bf16
    values there (one element of 1,920 here), so the cross-engine band
    adds the float64 effect of the two roundings, computed on these
    inputs."""
    jax_engine, port_engine = engines
    queries = _queries(corpus_texts)
    ref = jax_engine.search_batch(queries, k=5, mode=mode)
    got = port_engine.search_batch(queries, k=5, mode=mode)
    s64, n_tok = _engine_golden(port_engine, queries)
    r_tok = np.asarray(jax_engine._encode_query_tokens(queries)[0])
    r64, _ = _engine_golden(port_engine, queries, r_tok)
    tol = TOL * n_tok
    drift = np.abs(s64 - r64).max(axis=1)
    assert_equal_under_ties(_rows(got), _rows(ref), s64, tol + drift)
    for qi, expected in enumerate((10, 33, 61)):
        assert got[qi][0].doc_id == expected
    for row in got:
        assert all(r.keyword == 0.0 and r.semantic == r.score for r in row)
    if mode == "maxsim":
        assert_topk_equiv_scores(s64, *_rows(got), tol)
        assert_topk_equiv_scores(r64, *_rows(ref), tol)
    stages = port_engine.timer.snapshot()
    assert {"encode", "device_search"} <= set(stages)


def test_engine_rerank_matches_exact_maxsim_over_its_candidates(
        engines, corpus_texts):
    """maxsim-rerank = exact MaxSim over the dense stage's own top-C."""
    from legal_rag_tpu_torch.parallel.sharded import _local_dense_topc

    _, engine = engines
    queries = _queries(corpus_texts)
    k = 4
    got = engine.search_batch(queries, k=k, mode="maxsim-rerank")
    s64, n_tok = _engine_golden(engine, queries)
    padded = queries + [""] * (8 - len(queries))
    _, _, q_emb = engine._encode_query_tokens(padded)
    _, cand = _local_dense_topc(q_emb, engine.index.docs.full(), 0,
                                engine.store.n_docs, 2 * k)
    for qi, row in enumerate(got):
        pool = [c for c in cand[qi].tolist() if 0 <= c < engine.store.n_docs]
        want = sorted(pool, key=lambda c: (-s64[qi, c], c))[:k]
        assert [r.doc_id for r in row] == want
        np.testing.assert_allclose([r.score for r in row], s64[qi, want],
                                   rtol=0, atol=TOL * n_tok[qi])


def test_rerank_full_coverage_equals_full_scan(mv_store_dir):
    """With c covering every doc, dense-first MaxSim equals the full
    scan (and the JAX full scan)."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, ShardedMultiVectorIndex,
    )

    store = VectorStore.load(mv_store_dir)
    toks = np.asarray(store.mv_tokens, np.float32)
    mask = np.asarray(store.mv_mask, np.int32)
    emb = np.asarray(store.embeddings, np.float32)
    n = store.n_docs
    rng = np.random.default_rng(17)
    q_emb = emb[[3, 50, 70, 11]] + 0.01 * rng.standard_normal(
        (4, store.dim)).astype(np.float32)
    q = rng.standard_normal((4, 6, store.dim)).astype(np.float32)
    qm = np.ones((4, 6), np.int32)
    qm[1, 4:] = 0

    ref_s, ref_i = jax_maxsim_topk(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(toks),
        jnp.asarray(mask), k=7, block_n=64)
    sidx = ShardedIndex.from_embeddings(emb, dtype="float32", device="cpu")
    midx = ShardedMultiVectorIndex.from_arrays(
        toks, mask, dtype="float32", n_pad=int(sidx.docs.shape[0]),
        device="cpu")
    s, i = midx.rerank_search(sidx, q_emb, q, qm, k=7, c=n)
    fs, fi = midx.search(q, qm, k=7, block_n=64)
    assert torch.equal(i, fi)
    torch.testing.assert_close(s, fs, rtol=0, atol=0)
    s64 = golden_maxsim(q, qm, toks, mask)
    tol = TOL * qm.sum(axis=1)
    assert_equal_under_ties((s, i), (np.asarray(ref_s), np.asarray(ref_i)),
                            s64, tol)
    assert_topk_equiv_scores(s64, s.numpy(), i.numpy(), tol)


def test_rerank_refuses_a_quantized_tier_or_other_padding(mv_store_dir):
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, ShardedMultiVectorIndex,
    )

    store = VectorStore.load(mv_store_dir)
    emb = np.asarray(store.embeddings, np.float32)
    q = np.ones((1, 2, store.dim), np.float32)
    qm = np.ones((1, 2), np.int32)
    midx = ShardedMultiVectorIndex.from_arrays(
        store.mv_tokens, store.mv_mask, n_pad=store.n_docs + 3, device="cpu")
    assert midx.doc_tokens.dtype == torch.bfloat16
    assert midx.doc_tokens.shape[0] == store.n_docs + 3
    int8 = ShardedIndex.from_embeddings(emb, dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="float/bf16 dense tier"):
        midx.rerank_search(int8, emb[:1], q, qm, k=3, c=6)
    fp32 = ShardedIndex.from_embeddings(emb, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="share row padding"):
        midx.rerank_search(fp32, emb[:1], q, qm, k=3, c=6)
    with pytest.raises(ValueError, match="n_pad"):
        ShardedMultiVectorIndex.from_arrays(
            store.mv_tokens, store.mv_mask, n_pad=store.n_docs - 1,
            device="cpu")


def test_multi_vector_searcher_self_retrieval(mv_store_dir, corpus_texts):
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = RetrievalEngine(VectorStore.load(mv_store_dir), config=TINY_CFG,
                             device="cpu")
    texts = corpus_texts[:40]
    searcher = MultiVectorSearcher(texts, engine.encoder, token_budget=16,
                                   batch_size=16, block_n=8)
    s, i = searcher.search([texts[5], texts[27]], k=3)
    assert i[:, 0].tolist() == [5, 27]
    assert np.isfinite(s).all()


# -- the port's server ------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(store, config):
    from legal_rag_tpu_torch.cli import BackgroundServer
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    legal = LegalEngine(store=store, config=config, use_llm=False,
                        device="cpu")
    return legal, BackgroundServer(legal)


def test_server_answers_both_modes(mv_store_dir, corpus_texts):
    from legal_rag_tpu_torch.index.store import VectorStore

    legal, server = _serve(VectorStore.load(mv_store_dir), TINY_CFG)
    queries = _queries(corpus_texts)
    try:
        answers = {mode: _post(f"{server.url}/api/v1/batch_search",
                               {"queries": queries, "k": 5,
                                "fusion_mode": mode})
                   for mode in ("maxsim", "maxsim-rerank")}
    finally:
        server.stop()
    for mode, (status, body) in answers.items():
        assert status == 200, body
        want = legal.engine.search_batch(queries, k=5, mode=mode)
        got = body["results"]
        assert [[(r["doc_id"], r["score"]) for r in row] for row in got] == [
            [(r.doc_id, r.score) for r in row] for row in want]
        assert [row[0]["doc_id"] for row in got[:3]] == [10, 33, 61]


def test_server_refuses_maxsim_rerank_on_a_quantized_tier(mv_store_dir):
    from legal_rag_tpu_torch.index.store import VectorStore

    cfg = dataclasses.replace(TINY_CFG, dense=dataclasses.replace(
        TINY_CFG.dense, dtype="int8"))
    _, server = _serve(VectorStore.load(mv_store_dir), cfg)
    try:
        rerank = _post(f"{server.url}/api/v1/batch_search",
                       {"queries": ["police fir"], "fusion_mode":
                        "maxsim-rerank"})
        full = _post(f"{server.url}/api/v1/batch_search",
                     {"queries": ["police fir"], "fusion_mode": "maxsim"})
    finally:
        server.stop()
    assert rerank[0] == 422 and "float32/bfloat16" in rerank[1]["detail"]
    assert full[0] == 200 and len(full[1]["results"][0]) == 5


def test_server_refuses_maxsim_without_a_slab(corpus_texts, tmp_path):
    from legal_rag_tpu.index.builder import build_index
    from legal_rag_tpu_torch.index.store import VectorStore

    build_index(
        [{"text": t, "metadata": {}, "canonical_header": str(i),
          "section_id": None} for i, t in enumerate(corpus_texts[:16])],
        config=TINY_CFG, store_dir=tmp_path,
    )
    legal, server = _serve(VectorStore.load(tmp_path), TINY_CFG)
    try:
        answers = [_post(f"{server.url}/api/v1/batch_search",
                         {"queries": ["police"], "fusion_mode": mode})
                   for mode in ("maxsim", "maxsim-rerank")]
    finally:
        server.stop()
    for status, body in answers:
        assert status == 422 and "multi-vector" in body["detail"]
    with pytest.raises(ValueError, match="multi-vector"):
        legal.engine.search_batch(["anything"], k=3, mode="maxsim")



# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxsim_ops_on_gpu_match_cpu(cuda, data, dtype):
    q_tokens, q_mask, doc_tokens, doc_mask = data
    tdt = DTYPES[dtype][0]
    args = [torch.from_numpy(q_tokens).to(tdt), torch.from_numpy(q_mask),
            torch.from_numpy(doc_tokens).to(tdt), torch.from_numpy(doc_mask)]
    cand = torch.randint(-2, 305, (3, 40), generator=torch.Generator()
                         .manual_seed(0)).int()
    tol = TOL * q_mask.sum(axis=1)
    s64 = golden_maxsim(_rounded(q_tokens, dtype), q_mask,
                        _rounded(doc_tokens, dtype), doc_mask)
    cpu = maxsim_topk(*args, 12, block_n=64, n_valid=290)
    gpu = maxsim_topk(*(a.to(cuda) for a in args), 12, block_n=64,
                      n_valid=290)
    assert_equal_under_ties((gpu[0].cpu(), gpu[1].cpu()), cpu, s64, tol)
    cpu = maxsim_rescore(*args, cand, 16, n_valid=290)
    gpu = maxsim_rescore(*(a.to(cuda) for a in args), cand.to(cuda), 16,
                         n_valid=290)
    assert torch.equal(gpu[1].cpu(), cpu[1])
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=0,
                               atol=float(tol.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["maxsim", "maxsim-rerank"])
def test_engine_mode_on_gpu_matches_cpu(cuda, engines, mv_store_dir,
                                        corpus_texts, mode):
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    _, cpu_engine = engines
    card = RetrievalEngine(VectorStore.load(mv_store_dir), config=TINY_CFG,
                           device="cuda")
    queries = _queries(corpus_texts)
    got = card.search_batch(queries, k=5, mode=mode)
    ref = cpu_engine.search_batch(queries, k=5, mode=mode)
    s64, n_tok = _engine_golden(cpu_engine, queries)
    assert_equal_under_ties(_rows(got), _rows(ref), s64, TOL * n_tok)


# -- the synthetic store's slab and the bench script --------------------------


PLANTED = ("What is the procedure to file an FIR?", "punishment for robbery")


@pytest.fixture(scope="module")
def synthetic_mv(tmp_path_factory):
    from legal_rag_tpu_torch.index.synthetic import synthesize_store

    cfg = EncoderConfig(vocab_size=3000, hidden=32, layers=2, heads=4,
                        intermediate=64, max_len=64)
    mv_dir = tmp_path_factory.mktemp("synthetic_mv")
    store = synthesize_store(600, seed=4, planted=PLANTED, cfg=cfg,
                             device="cpu", multi_vector=TD, mv_dir=mv_dir)
    return store, mv_dir


def test_synthetic_slab_layout(synthetic_mv):
    from legal_rag_tpu_torch.index.synthetic import planted_ids

    store, mv_dir = synthetic_mv
    toks, mask = store.mv_tokens, store.mv_mask
    assert isinstance(toks, np.memmap) and toks.filename == str(
        mv_dir / "mv_tokens.npy")
    assert toks.dtype == np.float16 and mask.dtype == np.uint8
    assert toks.shape == (600, TD, 32) and mask.shape == (600, TD)
    assert store.build_params["multi_vector"] == TD
    # real tokens: the BM25 length clipped to Td (planted docs: their
    # query's WordPiece tokens), unit vectors; padding slots zero
    plant = planted_ids(600, len(PLANTED))
    count = mask.sum(axis=1)
    others = np.setdiff1d(np.arange(600), plant)
    np.testing.assert_array_equal(
        count[others], np.minimum(store.bm25.doc_len[others], TD))
    assert (mask == (np.arange(TD)[None] < count[:, None])).all()
    real = np.asarray(toks, np.float32)[mask > 0]
    np.testing.assert_allclose(np.linalg.norm(real, axis=1), 1.0, atol=2e-3)
    assert (np.asarray(toks)[mask == 0] == 0).all()
    # a doc's tokens are its embedding plus 0.25 noise a dim: cosine
    # 1 / sqrt(1 + 0.0625 D) on average
    cos = np.einsum("ntd,nd->nt", np.asarray(toks[others], np.float32),
                    store.embeddings[others])[mask[others] > 0]
    assert abs(cos.mean() - 1 / np.sqrt(1 + 0.0625 * 32)) < 0.02


@pytest.mark.parametrize("mode", ["maxsim", "maxsim-rerank"])
def test_synthetic_planted_docs_rank_first(synthetic_mv, mode):
    from legal_rag_tpu_torch.index.synthetic import planted_ids
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store, _ = synthetic_mv
    engine = RetrievalEngine(store, device="cpu")
    rows = engine.search_batch(list(PLANTED), k=5, mode=mode)
    assert [r[0].doc_id for r in rows] == planted_ids(600, len(PLANTED))
    # each planted doc holds its query's own tokens: every real query
    # token finds itself (bf16-rounded) in it
    _, q_mask, _ = engine._encode_query_tokens(list(PLANTED))
    for row, m in zip(rows, q_mask):
        assert row[0].score == pytest.approx(m.sum(), abs=0.02 * m.sum())


def test_synthetic_slab_needs_a_directory():
    from legal_rag_tpu_torch.index.synthetic import synthesize_store

    with pytest.raises(ValueError, match="mv_dir"):
        synthesize_store(50, device="cpu", multi_vector=4,
                         cfg=EncoderConfig(vocab_size=500, hidden=32,
                                           layers=1, heads=4,
                                           intermediate=64, max_len=32))


def test_bench_maxsim_scale_runs_on_cpu():
    """The bench at a tiny size: the path runs, no device time is taken
    on the CPU, and the rerank finds each query's target doc."""
    from legal_rag_tpu_torch.scripts import bench_maxsim_scale

    lines = []
    out = bench_maxsim_scale.run(2048, 4, "cpu", log=lines.append)
    assert out["full_ms"] is None and out["rerank_ms"] is None
    assert out["top1"] == 1.0 and 0 < out["overlap"] <= 1.0
    assert len(lines) == 3 and "not timed" in lines[0]
