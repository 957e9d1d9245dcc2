"""The int8 capacity tier of the port against the JAX package: the
per-segment quantization, the int8 two-phase top-k (K1's int8 variant;
its plain version here), the small-N int8 path, the int8 engine with
and without the fp32 rescore, and the ``--dense-dtype`` serving switch.

Tolerances: int8 codes, scales and the int32 segment map are exact
(integer arithmetic; the fp32 matmul of int8 values is exact below
2**24); dequantized scores are the same fp32 products in the same
order, compared at 1e-6; ids exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.parallel.sharded as jsh
import legal_rag_tpu_torch.ops.dense as tdense
import legal_rag_tpu_torch.parallel.sharded as tsh
from legal_rag_tpu.config import DenseConfig, EncoderConfig, RetrievalConfig
from legal_rag_tpu.ops.dense import dense_topk_twophase_rm as jax_twophase
from legal_rag_tpu.parallel.mesh import make_mesh
from legal_rag_tpu_torch.ops import segmax_rm as k1
from legal_rag_tpu_torch.ops.dense import dense_topk_twophase_rm

FORCED = 2048
SCORE_TOL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    docs = _unit(rng, 4093, 64)
    docs[2000:2016] = docs[5]          # duplicates: exact int8 ties
    queries = _unit(rng, 6, 64)
    queries[2] = docs[5]
    return queries, docs


def test_quantize_queries_matches_the_jax_formula(data):
    """round(q / (max|q| / 127)) half to even, clipped; a zero row keeps
    scale 1 (sharded.py:100-104)."""
    queries, _ = data
    q = np.concatenate([queries, np.zeros((1, 64), np.float32)])
    q[0, :4] = [0.5, -0.5, 1.5 / 127, 2.5 / 127]     # halves round to even
    got_q, got_s = tdense.quantize_queries(torch.from_numpy(q))
    jq = jnp.asarray(q)
    scale = jnp.max(jnp.abs(jq), axis=1) / 127.0
    scale = jnp.where(scale == 0, 1.0, scale)
    want = jnp.clip(jnp.round(jq / scale[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scale))
    assert got_s[-1] == 1.0 and not got_q[-1].any()


@pytest.fixture
def forced(monkeypatch):
    """Both packages' large-N dispatch lowered to FORCED docs."""
    for mod in (jsh, tsh):
        monkeypatch.setattr(mod, "TWOPHASE_MIN_DOCS", FORCED)
        monkeypatch.setattr(mod, "TWOPHASE_BLOCK_N", FORCED)
    jsh.sharded_hybrid_search.clear_cache()
    yield
    jsh.sharded_hybrid_search.clear_cache()


@pytest.mark.parametrize("force", [False, True])
def test_int8_quantization_bit_equal(data, request, force):
    """Per-segment codes and scales, with the 8-row and (forced) the
    8192-row padding."""
    if force:
        request.getfixturevalue("forced")
    _, docs = data
    ref = jsh.ShardedIndex.from_embeddings(docs, make_mesh(1), dtype="int8")
    got = tsh.ShardedIndex.from_embeddings(docs, dtype="int8", device="cpu")
    assert got.docs.dtype == torch.int8 and got.n_docs == len(docs)
    np.testing.assert_array_equal(got.docs.numpy(), np.asarray(ref.docs))
    np.testing.assert_array_equal(got.doc_scales.numpy(),
                                  np.asarray(ref.doc_scales))
    assert got.docs.shape[0] % (FORCED if force else 8) == 0


def test_int8_segment_map_is_exact(data):
    """K1-int8's plain version: the int32 segment maxima of the int8
    dot products, rows >= n_valid at -2**30."""
    queries, docs = data
    idx = tsh.ShardedIndex.from_embeddings(docs, dtype="int8", device="cpu")
    q_i8, _ = tdense.quantize_queries(torch.from_numpy(queries))
    got = k1.segmax_rm_reference(q_i8, idx.docs.full(), 4001)
    d64 = idx.docs.numpy().astype(np.int64)
    s = q_i8.numpy().astype(np.int64) @ d64.T
    s[:, 4001:] = -(2 ** 30)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), s.reshape(6, -1, 8).max(axis=2))


@pytest.mark.parametrize("n_valid", [None, 4001, 3993])
def test_int8_twophase_matches_jax(data, n_valid):
    queries, docs = data
    idx = tsh.ShardedIndex.from_embeddings(docs, dtype="int8", device="cpu")
    k = 12
    ref_s, ref_i = jax_twophase(
        jnp.asarray(queries), jnp.asarray(idx.docs.numpy()), k,
        block_n=1024, block_q=8, n_valid=n_valid, interpret=True,
        doc_scales=jnp.asarray(idx.doc_scales.numpy()),
    )
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries), idx.docs.full(), k, n_valid=n_valid,
        doc_scales=idx.doc_scales.full(),
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s),
                               atol=SCORE_TOL, rtol=0)
    # the duplicates of doc 5 tie exactly and come back by ascending id
    assert list(got_i[2, :12].numpy()) == [5] + list(range(2000, 2011))


def _hybrid_inputs(n, q=8, p=256, seed=33):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (q, p)).astype(np.int32)
    w = rng.gamma(2.0, 1.0, (q, p)).astype(np.float32)
    weights = np.array([0.5, 0.0, 0.3, 0.5, 1.0, 0.6, 0.5, 0.2], np.float32)
    return ids, w, weights


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_int8_hybrid_both_dispatch_sides_match_jax(
    data, request, monkeypatch, force, mode
):
    """The small-N int8 matmul path and (forced) the two-phase K1-int8
    path through the port's sharded_hybrid_search, against JAX's."""
    if force:
        request.getfixturevalue("forced")
    calls = []
    seg = tdense.segmax_rm
    monkeypatch.setattr(tdense, "segmax_rm",
                        lambda *a, **kw: calls.append(1) or seg(*a, **kw))
    queries, docs = data
    n = len(docs)
    q_emb = np.concatenate([queries, _unit(np.random.default_rng(1), 2, 64)])
    ids, w, weights = _hybrid_inputs(n)
    mesh = make_mesh(1)
    jidx = jsh.ShardedIndex.from_embeddings(docs, mesh, dtype="int8")
    ref = jsh.sharded_hybrid_search(
        jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q_emb),
        jnp.asarray(weights), jidx.doc_scales, mesh=mesh, k=10, c=20,
        n_docs=n, mode=mode,
    )
    tidx = tsh.ShardedIndex.from_embeddings(docs, dtype="int8", device="cpu")
    got = tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(q_emb), torch.from_numpy(weights),
        tidx.doc_scales, mesh=tidx.mesh, k=10, c=20, n_docs=n, mode=mode,
    )
    assert len(calls) == (1 if force else 0)
    f, i, sem, key = (x.numpy() for x in got)
    rf, ri, rsem, rkey = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(f, rf, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sem, rsem, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(key, rkey, atol=1e-5, rtol=0)


# -- the engine ----------------------------------------------------------

ENC = EncoderConfig(vocab_size=500, hidden=32, layers=1, heads=4,
                    intermediate=64, max_len=32)
QUERIES = ["word3 law2", "clause4 word11", "law5 word20 clause0"]


def _cfg(dtype, **dense):
    return RetrievalConfig(encoder=ENC,
                           dense=DenseConfig(dtype=dtype, **dense))


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """The store of tests/test_int8_rescore.py's engine test, built by
    the JAX package and saved with its encoder weights."""
    from legal_rag_tpu.index.builder import build_index

    chunks = [
        {"text": f"H\n\nword{i} law{i % 7} clause{i % 5} " * 3,
         "canonical_header": "H", "metadata": {"law": "T"}}
        for i in range(50)
    ]
    store = build_index(chunks, config=_cfg("float32"))
    path = tmp_path_factory.mktemp("int8_store")
    store.save(path)
    return path


def _engines(store_dir, cfg):
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    jax_engine = JaxEngine(JaxStore.load(store_dir), config=cfg,
                           mesh=make_mesh(1))
    return jax_engine, RetrievalEngine(VectorStore.load(store_dir), config=cfg,
                                       device="cpu")


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_int8_engine_matches_jax(store_dir, mode):
    cfg = _cfg("int8", int8_oversample=10)
    jax_engine, engine = _engines(store_dir, cfg)
    assert engine.index.docs.dtype == torch.int8
    want = jax_engine.search_batch(QUERIES, k=5, mode=mode)
    got = engine.search_batch(QUERIES, k=5, mode=mode)
    for a, b in zip(got, want):
        assert [r.doc_id for r in a] == [r.doc_id for r in b]
        np.testing.assert_allclose([r.score for r in a],
                                   [r.score for r in b], atol=1e-5)
    assert ("int8_rescore" in engine.timer.snapshot()) == (mode == "weighted")


def test_int8_weighted_engine_matches_port_fp32(store_dir):
    """tests/test_int8_rescore.py:106 on the port: with the rescore the
    int8 engine returns the fp32 engine's ids."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store = VectorStore.load(store_dir)
    e32 = RetrievalEngine(store, config=_cfg("float32"), device="cpu")
    e8 = RetrievalEngine(store, config=_cfg("int8", int8_oversample=10),
                         device="cpu")
    r32 = e32.search_batch(QUERIES, k=5, mode="weighted")
    r8 = e8.search_batch(QUERIES, k=5, mode="weighted")
    for a, b in zip(r32, r8):
        assert [x.doc_id for x in a] == [x.doc_id for x in b]
        assert [x.semantic for x in a] == pytest.approx(
            [x.semantic for x in b], rel=1e-4)


@pytest.mark.parametrize("how,dtype", [("flag", "int8"), ("env", "bfloat16")])
def test_serve_dense_dtype_reaches_the_engine(store_dir, monkeypatch, how,
                                              dtype):
    """``serve --dense-dtype`` and ``LEGAL_RAG_DENSE_DTYPE`` set the tier
    of the engine that the HTTP server is given."""
    import legal_rag_tpu_torch.server.app as app
    from legal_rag_tpu_torch import cli

    served = {}

    async def fake_run_server(engine=None, **kw):
        served["engine"] = engine

    monkeypatch.setattr(app, "run_server", fake_run_server)
    monkeypatch.setenv("LEGAL_RAG_NO_COALESCE", "1")
    argv = ["serve", "--store", str(store_dir), "--device", "cpu"]
    if how == "flag":
        monkeypatch.delenv("LEGAL_RAG_DENSE_DTYPE", raising=False)
        argv += ["--dense-dtype", dtype]
    else:
        monkeypatch.setenv("LEGAL_RAG_DENSE_DTYPE", dtype)
    assert cli.main(argv) == 0
    engine = served["engine"].engine
    assert engine.config.dense.dtype == dtype
    want = {"int8": torch.int8, "bfloat16": torch.bfloat16}[dtype]
    assert engine.index.docs.dtype == want


def test_serving_config_picks_the_tier(monkeypatch):
    from legal_rag_tpu_torch.cli import serving_config

    monkeypatch.delenv("LEGAL_RAG_DENSE_DTYPE", raising=False)
    assert serving_config().dense.dtype == "float32"
    assert serving_config("pq").dense.dtype == "pq"
    monkeypatch.setenv("LEGAL_RAG_DENSE_DTYPE", "int8")
    assert serving_config().dense.dtype == "int8"
    assert serving_config("bfloat16").dense.dtype == "bfloat16"
    with pytest.raises(ValueError, match="dense dtype"):
        serving_config("fp8")


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_valid", [(8, 8 * 1500 - 5), (70, 8 * 1400 + 3)])
def test_segmax_int8_kernel_bit_equal_on_gpu(cuda, n_q, n_valid):
    rng = np.random.default_rng(37)
    docs = _unit(rng, 8 * 1500, 384)
    docs[100:140] = docs[3]
    idx = tsh.ShardedIndex.from_embeddings(docs, dtype="int8", device=cuda)
    q_i8, _ = tdense.quantize_queries(
        torch.from_numpy(_unit(rng, n_q, 384)).to(cuda))
    before = k1.K1.int8_launches
    got = k1.segmax_rm(q_i8, idx.docs.full(), n_valid)
    torch.cuda.synchronize()
    assert k1.K1.int8_launches == before + 1
    ref = k1.segmax_rm_reference(q_i8, idx.docs.full(), n_valid)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)
