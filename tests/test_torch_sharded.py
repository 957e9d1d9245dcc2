"""The port's sharded search against the JAX package's at the same mesh
shape, on the CPU.

The same numpy-seeded inputs run through JAX's ``make_mesh(S)`` over the
8 virtual CPU devices and through the port's one-process mesh of S CPU
entries, for S in 1, 2, 4 and 8:

- ``sharded_hybrid_search`` in every storage tier (fp32, bf16, int8, PQ
  flat and PQ + IVF), weighted and RRF fusion, scatter and segment-sum
  BM25 (segsum forced with ``sparse_mode="segsum"``, as the reference
  allows, so no store needs 65,536 rows a shard);
- ``sharded_maxsim_topk`` and ``sharded_maxsim_rerank_topk``, whose
  per-shard candidates make results depend on S;
- a 2x4 ``make_mesh_2d`` against JAX's, the indivisible-batch and
  too-many-shards errors, and one engine query at S=2.

Ids must be equal (continuous random inputs leave no ties); fused and
dense scores within 1e-5 (fp32 sums in another order), the int8 tier's
within 1e-6 as tests/test_torch_quant.py holds it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.ops.pq as jpq
import legal_rag_tpu.parallel.sharded as jsh
from legal_rag_tpu.config import DenseConfig, EncoderConfig, RetrievalConfig
from legal_rag_tpu.parallel.mesh import make_mesh, make_mesh_2d
import legal_rag_tpu_torch.parallel.mesh as tmesh
import legal_rag_tpu_torch.parallel.sharded as tsh

N, D, Q, P = 1000, 32, 8, 64
K, C = 10, 20
TOL = 1e-5
TIERS = ("float32", "bfloat16", "int8", "pq", "ivf")


def cpu_mesh(n_shards: int, data: int = 0) -> tmesh.Mesh:
    if data:
        return tmesh.Mesh([["cpu"] * n_shards] * data, ("data", "shard"))
    return tmesh.Mesh(["cpu"] * n_shards, ("shard",))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(61)
    centers = rng.standard_normal((40, D)).astype(np.float32)
    docs = centers[rng.integers(0, 40, N)] + 0.3 * rng.standard_normal(
        (N, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q_emb = rng.standard_normal((Q, D)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    q_emb[2] = docs[N - 7]                     # a hit in the last shard
    ids = rng.integers(0, N, (Q, P)).astype(np.int32)
    w = rng.gamma(2.0, 1.0, (Q, P)).astype(np.float32)
    ids[1, P // 2:] = N                        # gather padding
    w[1, P // 2:] = 0.0
    ids[3] = N                                 # a query with no postings
    w[3] = 0.0
    # query 2 dense only: its planted doc ranks first in weighted mode
    weights = np.array([0.5, 0.6, 0.0, 0.0, 0.5, 1.0, 0.3, 0.5], np.float32)
    return docs, ids, w, q_emb, weights


@pytest.fixture(scope="module")
def pq_parts(data):
    """Codebooks (OPQ), codes and IVF cells, trained by the JAX package
    and handed to both as numpy."""
    docs = data[0]
    cb = jpq.train_pq(docs, m=8, iters=8, seed=0, opq_iters=2)
    codes = jpq.encode_pq(docs, cb)
    ivf = jpq.build_ivf(docs, cb, codes, cell_size=8, iters=5)
    return cb, codes, ivf


def _indexes(tier, data, pq_parts, n_shards, jmesh, mesh):
    """(JAX index, port index) of one tier at one mesh shape."""
    docs = data[0]
    if tier in ("float32", "bfloat16", "int8"):
        return (jsh.ShardedIndex.from_embeddings(docs, jmesh, dtype=tier),
                tsh.ShardedIndex.from_embeddings(docs, mesh, dtype=tier))
    cb, codes, ivf = pq_parts
    if tier == "pq":
        return (jsh.ShardedIndex.from_pq(codes, cb.codebooks, jmesh,
                                         rotation=cb.rotation),
                tsh.ShardedIndex.from_pq(codes, cb.codebooks, mesh,
                                         rotation=cb.rotation))
    return (jsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks, jmesh,
                                         rotation=cb.rotation),
            tsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks, mesh,
                                         rotation=cb.rotation))


def _search_both(tier, data, pq_parts, n_shards, mode, sparse_mode,
                 data_axis=None, jmesh=None, mesh=None):
    docs, ids, w, q_emb, weights = data
    jmesh = jmesh or make_mesh(n_shards)
    mesh = mesh or cpu_mesh(n_shards)
    jidx, tidx = _indexes(tier, data, pq_parts, n_shards, jmesh, mesh)
    q = q_emb if tidx.pq_rotation is None else q_emb @ tidx.pq_rotation
    kw = dict(k=K, c=C, n_docs=jidx.n_docs, mode=mode,
              sparse_mode=sparse_mode, data_axis=data_axis, ivf_probes=4,
              ivf_cell_size=jidx.ivf_cell_size or 1024)
    ref = jsh.sharded_hybrid_search(
        jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q),
        jnp.asarray(weights), jidx.doc_scales, jidx.pq_codebooks,
        jidx.ivf_centroids, jidx.ivf_doc_ids, mesh=jmesh, **kw,
    )
    got = tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(np.ascontiguousarray(q, np.float32)),
        torch.from_numpy(weights), tidx.doc_scales, tidx.pq_codebooks,
        tidx.ivf_centroids, tidx.ivf_doc_ids, mesh=mesh, **kw,
    )
    return tidx, [np.asarray(x) for x in ref], [x.numpy() for x in got]


def _assert_same(got, ref, tol=TOL):
    f, i, sem, key = got
    rf, ri, rsem, rkey = ref
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(f, rf, atol=tol, rtol=0)
    np.testing.assert_allclose(sem, rsem, atol=tol, rtol=0)
    np.testing.assert_allclose(key, rkey, atol=TOL, rtol=0)


CASES = [(tier, mode, sparse) for tier in TIERS
         for mode in ("weighted", "rrf")
         for sparse in (("segsum",) if tier == "ivf" else ("scatter", "segsum"))]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("tier,mode,sparse_mode", CASES)
def test_hybrid_matches_jax_at_equal_shards(data, pq_parts, n_shards, tier,
                                            mode, sparse_mode):
    tidx, ref, got = _search_both(tier, data, pq_parts, n_shards, mode,
                                  sparse_mode)
    assert tidx.docs.shape[0] % n_shards == 0
    assert len({id(t) for t in tidx.docs.blocks.values()}) == n_shards
    _assert_same(got, ref, 1e-6 if tier == "int8" else TOL)
    if mode == "weighted" and tier in ("float32", "bfloat16"):
        assert got[1][2, 0] == N - 7      # the last shard's hit ranks first


def test_int8_padding_moves_with_shards(data):
    """The int8 tier pads each shard to whole 8-row segments, as the
    reference does: the padded row count and the scales depend on S."""
    docs = data[0][:997]
    for n_shards in (1, 2, 4, 8):
        ref = jsh.ShardedIndex.from_embeddings(docs, make_mesh(n_shards),
                                               dtype="int8")
        got = tsh.ShardedIndex.from_embeddings(docs, cpu_mesh(n_shards),
                                               dtype="int8")
        assert got.docs.shape == tuple(ref.docs.shape)
        np.testing.assert_array_equal(got.docs.numpy(), np.asarray(ref.docs))
        np.testing.assert_array_equal(got.doc_scales.numpy(),
                                      np.asarray(ref.doc_scales))


def test_ivf_cells_pad_to_the_mesh(data, pq_parts):
    """IVF cells pad to a multiple of S with empty cells (ids -1), each
    shard a run of whole cells."""
    cb, _, ivf = pq_parts
    for n_shards in (1, 2, 4, 8):
        ref = jsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks,
                                           make_mesh(n_shards))
        got = tsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks,
                                           cpu_mesh(n_shards))
        for name in ("docs", "ivf_centroids", "ivf_doc_ids"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        assert got.ivf_centroids.shape[0] % n_shards == 0
        assert got.n_docs == ref.n_docs == N


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_2d_mesh_matches_jax(data, pq_parts, mode, tier):
    """A 2x4 (data, shard) mesh: the batch splits over rows, documents
    over columns; the port's equals JAX's make_mesh_2d(2, 4), and both
    equal the 1-D 4-shard result."""
    tidx, ref, got = _search_both(
        tier, data, pq_parts, 4, mode, "scatter", data_axis="data",
        jmesh=make_mesh_2d(2, 4), mesh=cpu_mesh(4, data=2))
    _assert_same(got, ref, 1e-6 if tier == "int8" else TOL)
    _, ref1, got1 = _search_both(tier, data, pq_parts, 4, mode, "scatter")
    _assert_same(got1, got, 0.0)
    assert len(tidx.docs.blocks) == 8


def test_2d_mesh_ivf_marks_real_rows_by_global_index(data, pq_parts):
    """IVF on a 2-D mesh: padded batch rows (past n_queries) do not vote
    for cells, by their global query index."""
    docs, ids, w, q_emb, weights = data
    cb, _, ivf = pq_parts
    jmesh, mesh = make_mesh_2d(2, 2), cpu_mesh(2, data=2)
    jidx = jsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks, jmesh,
                                        rotation=cb.rotation)
    tidx = tsh.ShardedIndex.from_pq_ivf(ivf, cb.codebooks, mesh,
                                        rotation=cb.rotation)
    q = np.ascontiguousarray(q_emb @ tidx.pq_rotation, np.float32)
    kw = dict(k=K, c=C, n_docs=N, data_axis="data", ivf_probes=4,
              ivf_cell_size=8, n_queries=5)
    ref = jsh.sharded_hybrid_search(
        jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q),
        jnp.asarray(weights), None, jidx.pq_codebooks, jidx.ivf_centroids,
        jidx.ivf_doc_ids, mesh=jmesh, **kw)
    got = tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(q), torch.from_numpy(weights), None,
        tidx.pq_codebooks, tidx.ivf_centroids, tidx.ivf_doc_ids, mesh=mesh,
        **kw)
    _assert_same([x.numpy() for x in got], [np.asarray(x) for x in ref])


def test_2d_mesh_rejects_indivisible_batch(data):
    docs, ids, w, q_emb, weights = data
    mesh = cpu_mesh(4, data=2)
    tidx = tsh.ShardedIndex.from_embeddings(docs, mesh)
    with pytest.raises(ValueError, match="divide data axis"):
        tsh.sharded_hybrid_search(
            tidx.docs, torch.from_numpy(ids[:3]), torch.from_numpy(w[:3]),
            torch.from_numpy(q_emb[:3]), torch.from_numpy(weights[:3]),
            mesh=mesh, data_axis="data", k=5, c=10, n_docs=N,
        )
    midx = tsh.ShardedMultiVectorIndex.from_arrays(
        np.zeros((N, 4, D), np.float32), np.ones((N, 4), np.int32), mesh,
        dtype="float32")
    with pytest.raises(ValueError, match="divide data axis"):
        tsh.sharded_maxsim_topk(
            midx.doc_tokens, midx.doc_mask, torch.zeros(3, 2, D),
            torch.ones(3, 2, dtype=torch.int32), mesh=mesh, k=5, n_docs=N,
            data_axis="data")


def test_too_many_shards_raise():
    """make_mesh and make_mesh_2d refuse more shards than devices, as
    the reference refuses more than len(jax.devices())."""
    with pytest.raises(ValueError, match="requested 2 shards but only 1"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="requested 2x2 mesh but only 1"):
        tmesh.make_mesh_2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="requested 9 shards but only 8"):
        make_mesh(9)
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"shard": 1} and mesh.devices[0] == torch.device("cpu")


def test_device_put_global_and_replicate(data):
    """Row slices on each position (shared where a position repeats its
    device and slice), the whole array on each device replicated."""
    docs = data[0][:96]
    mesh = cpu_mesh(4, data=2)
    g = tmesh.device_put_global(docs, mesh, ("shard", None))
    assert g.shape == (96, D) and len(g.blocks) == 8
    for (d, s), t in g.blocks.items():
        np.testing.assert_array_equal(t.numpy(), docs[s * 24:(s + 1) * 24])
        assert t is g.blocks[(0, s)]
    np.testing.assert_array_equal(g.numpy(), docs)
    r = tmesh.replicate_global(docs, mesh)
    assert all(t is r.blocks[(0, 0)] for t in r.blocks.values())
    np.testing.assert_array_equal(r.full().numpy(), docs)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.device_put_global(docs[:95], mesh)


# -- late interaction --------------------------------------------------------

TD, TQ = 6, 4


@pytest.fixture(scope="module")
def mv_data(data):
    rng = np.random.default_rng(62)
    docs = data[0][:301]
    toks = rng.standard_normal((301, TD, D)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=2, keepdims=True)
    mask = (rng.random((301, TD)) < 0.8).astype(np.int32)
    mask[:, 0] = 1
    toks *= mask[:, :, None]
    q_tok = rng.standard_normal((Q, TQ, D)).astype(np.float32)
    q_tok /= np.linalg.norm(q_tok, axis=2, keepdims=True)
    q_tok[1] = toks[297, :TQ]                 # a hit in the last shard
    q_mask = np.ones((Q, TQ), np.int32)
    q_mask[3, 2:] = 0
    return docs, toks, mask, q_tok, q_mask, data[3]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_maxsim_topk_matches_jax(mv_data, n_shards):
    docs, toks, mask, q_tok, q_mask, _ = mv_data
    jmesh, mesh = make_mesh(n_shards), cpu_mesh(n_shards)
    jmv = jsh.ShardedMultiVectorIndex.from_arrays(toks, mask, jmesh,
                                                  dtype="float32")
    tmv = tsh.ShardedMultiVectorIndex.from_arrays(toks, mask, mesh,
                                                  dtype="float32")
    rs, ri = jmv.search(q_tok, q_mask, k=K, block_n=16)
    gs, gi = tmv.search(q_tok, q_mask, k=K, block_n=16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=TOL, rtol=0)
    assert gi[1, 0] == 297


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_maxsim_rerank_matches_jax(mv_data, n_shards):
    """Each shard rescoring its own dense top-c: results depend on S,
    and the port's equal JAX's at each S."""
    docs, toks, mask, q_tok, q_mask, q_emb = mv_data
    jmesh, mesh = make_mesh(n_shards), cpu_mesh(n_shards)
    jidx = jsh.ShardedIndex.from_embeddings(docs, jmesh)
    tidx = tsh.ShardedIndex.from_embeddings(docs, mesh)
    n_pad = tidx.docs.shape[0]
    assert n_pad == jidx.docs.shape[0]
    jmv = jsh.ShardedMultiVectorIndex.from_arrays(toks, mask, jmesh,
                                                  dtype="float32", n_pad=n_pad)
    tmv = tsh.ShardedMultiVectorIndex.from_arrays(toks, mask, mesh,
                                                  dtype="float32", n_pad=n_pad)
    rs, ri = jmv.rerank_search(jidx, q_emb, q_tok, q_mask, k=K, c=12)
    gs, gi = tmv.rerank_search(tidx, q_emb, q_tok, q_mask, k=K, c=12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=TOL, rtol=0)


def test_maxsim_2d_mesh_matches_jax(mv_data):
    docs, toks, mask, q_tok, q_mask, q_emb = mv_data
    jmesh, mesh = make_mesh_2d(2, 4), cpu_mesh(4, data=2)
    jidx = jsh.ShardedIndex.from_embeddings(docs, jmesh)
    tidx = tsh.ShardedIndex.from_embeddings(docs, mesh)
    n_pad = tidx.docs.shape[0]
    jmv = jsh.ShardedMultiVectorIndex.from_arrays(toks, mask, jmesh,
                                                  dtype="float32", n_pad=n_pad)
    tmv = tsh.ShardedMultiVectorIndex.from_arrays(toks, mask, mesh,
                                                  dtype="float32", n_pad=n_pad)
    for fn, args in (
        (jsh.sharded_maxsim_topk, dict(k=K, n_docs=301, block_n=16)),
        (jsh.sharded_maxsim_rerank_topk, dict(k=K, c=12, n_docs=301)),
    ):
        tfn = getattr(tsh, fn.__name__)
        if fn is jsh.sharded_maxsim_topk:
            jin = (jmv.doc_tokens, jmv.doc_mask)
            tin = (tmv.doc_tokens, tmv.doc_mask)
            q = (q_tok, q_mask)
        else:
            jin = (jidx.docs, jmv.doc_tokens, jmv.doc_mask)
            tin = (tidx.docs, tmv.doc_tokens, tmv.doc_mask)
            q = (q_emb, q_tok, q_mask)
        rs, ri = fn(*jin, *(jnp.asarray(x) for x in q), mesh=jmesh,
                    data_axis="data", **args)
        gs, gi = tfn(*tin, *(torch.from_numpy(x) for x in q), mesh=mesh,
                     data_axis="data", **args)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=TOL,
                                   rtol=0)


# -- the engine ---------------------------------------------------------------

ENC = EncoderConfig(vocab_size=500, hidden=32, layers=1, heads=4,
                    intermediate=64, max_len=32)
QUERIES = ["word3 law2", "clause4 word11", "law5 word20 clause0"]


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    from legal_rag_tpu.index.builder import build_index

    chunks = [
        {"text": f"H\n\nword{i} law{i % 7} clause{i % 5} " * 3,
         "canonical_header": "H", "metadata": {"law": "T"}}
        for i in range(61)
    ]
    cfg = RetrievalConfig(encoder=ENC)
    store = build_index(chunks, config=cfg)
    path = tmp_path_factory.mktemp("sharded_store")
    store.save(path)
    return path


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_engine_query_at_two_shards(store_dir, mode):
    """One search_batch through the port's engine on a 2-shard mesh
    equals the JAX engine's on make_mesh(2)."""
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    cfg = RetrievalConfig(encoder=ENC, dense=DenseConfig(dtype="float32"))
    jax_engine = JaxEngine(JaxStore.load(store_dir), config=cfg,
                           mesh=make_mesh(2))
    engine = RetrievalEngine(VectorStore.load(store_dir), config=cfg,
                             device="cpu", mesh=cpu_mesh(2))
    assert engine.index.docs.shape[0] == 62
    want = jax_engine.search_batch(QUERIES, k=5, mode=mode)
    got = engine.search_batch(QUERIES, k=5, mode=mode)
    for a, b in zip(got, want):
        assert [r.doc_id for r in a] == [r.doc_id for r in b]
        np.testing.assert_allclose([r.score for r in a],
                                   [r.score for r in b], atol=TOL)


def test_engine_default_mesh_is_one_device(store_dir):
    """num_shards=None on the CPU: one shard, the served default."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = RetrievalEngine(VectorStore.load(store_dir),
                             config=RetrievalConfig(encoder=ENC),
                             device="cpu")
    assert engine.mesh.shape == {"shard": 1}
    assert engine.index.docs.shape[0] == 61
