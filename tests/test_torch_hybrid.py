"""The port's ``sharded_hybrid_search`` against the JAX package's at the
same mesh size, 1 and 8 shards (the port's mesh of 8 CPU entries, JAX's
8 virtual CPU devices): weighted and RRF fusion, scatter and segment-sum
BM25, with the large-N dispatch forced down so both sides take the
two-phase path around K1 in every shard (a counter on each side shows
that they did).

Tolerance: fused and semantic scores atol 1e-5 (fp32 sums in another
order); ids exact. Postings carry continuous random weights so no two
BM25 totals tie within rounding.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.parallel.sharded as jsh
import legal_rag_tpu_torch.ops.dense as tdense
import legal_rag_tpu_torch.parallel.sharded as tsh
from legal_rag_tpu.parallel.mesh import make_mesh
from legal_rag_tpu_torch.parallel.mesh import Mesh

FORCED = 2048   # TWOPHASE_MIN_DOCS = TWOPHASE_BLOCK_N; fp32 blocks of 1024


def cpu_mesh(n_shards: int) -> Mesh:
    return Mesh(["cpu"] * n_shards, ("shard",))


def _inputs(n, d=64, q=8, p=512, seed=41):
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q_emb = rng.standard_normal((q, d)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    q_emb[2] = docs[n - 40]                    # a hit deep in the corpus
    ids = rng.integers(0, n, (q, p)).astype(np.int32)
    w = rng.gamma(2.0, 1.0, (q, p)).astype(np.float32)
    ids[1, p // 2:] = n                        # gather padding
    w[1, p // 2:] = 0.0
    ids[3] = n                                 # a query with no postings
    w[3] = 0.0
    ids[4, :64] = n - 40                       # deep doc on both channels
    weights = np.array([0.5, 0.6, 0.5, 0.0, 0.5, 1.0, 0.3, 0.5], np.float32)
    return docs, ids, w, q_emb, weights


@pytest.fixture
def forced_twophase(monkeypatch):
    """Both packages' large-N dispatch lowered to FORCED docs per shard,
    with a count of twophase calls on each side."""
    calls = {"jax": 0, "torch": 0}
    jax_fn, torch_fn = jsh.dense_topk_twophase_rm, tdense.segmax_rm

    def jax_counting(*a, **kw):
        calls["jax"] += 1            # runs while the mesh program traces
        return jax_fn(*a, **kw)

    def torch_counting(*a, **kw):
        calls["torch"] += 1
        return torch_fn(*a, **kw)

    for mod in (jsh, tsh):
        monkeypatch.setattr(mod, "TWOPHASE_MIN_DOCS", FORCED)
        monkeypatch.setattr(mod, "TWOPHASE_BLOCK_N", FORCED)
    monkeypatch.setattr(jsh, "dense_topk_twophase_rm", jax_counting)
    monkeypatch.setattr(tdense, "segmax_rm", torch_counting)
    jsh.sharded_hybrid_search.clear_cache()
    yield calls
    jsh.sharded_hybrid_search.clear_cache()


@pytest.mark.parametrize("n_dev,n", [(1, 3000), (8, 16900)])
@pytest.mark.parametrize("mode", ["weighted", "rrf"])
@pytest.mark.parametrize("sparse_mode", ["scatter", "segsum"])
def test_hybrid_matches_sharded_reference(
    forced_twophase, n_dev, n, mode, sparse_mode
):
    docs, ids, w, q_emb, weights = _inputs(n)
    k, c = 10, 20
    mesh = make_mesh(n_dev)
    jidx = jsh.ShardedIndex.from_embeddings(docs, mesh)
    ref = jsh.sharded_hybrid_search(
        jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q_emb),
        jnp.asarray(weights), mesh=mesh, k=k, c=c, n_docs=n, mode=mode,
        sparse_mode=sparse_mode,
    )
    tmesh = cpu_mesh(n_dev)
    tidx = tsh.ShardedIndex.from_embeddings(docs, tmesh, device="cpu")
    got = tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(q_emb), torch.from_numpy(weights), mesh=tmesh,
        k=k, c=c, n_docs=n, mode=mode, sparse_mode=sparse_mode,
    )
    assert forced_twophase["jax"] >= 1 and forced_twophase["torch"] == n_dev
    assert tidx.docs.shape[0] % FORCED == 0
    f, i, sem, key = (x.numpy() for x in got)
    rf, ri, rsem, rkey = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(f, rf, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sem, rsem, atol=1e-5, rtol=0)
    np.testing.assert_allclose(key, rkey, atol=1e-5, rtol=0)
    if mode == "weighted":
        assert i[2, 0] == n - 40   # the deep dense hit ranks first


def test_small_shard_takes_the_matmul_path(monkeypatch):
    calls = []
    monkeypatch.setattr(tdense, "segmax_rm",
                        lambda *a, **kw: calls.append(1))
    docs, ids, w, q_emb, weights = _inputs(600)
    tidx = tsh.ShardedIndex.from_embeddings(docs, cpu_mesh(1))
    f, i, _, _ = tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(q_emb), torch.from_numpy(weights),
        mesh=tidx.mesh, k=5, c=10, n_docs=600, mode="rrf",
    )
    assert calls == [] and tidx.docs.shape[0] == 600
    assert i.shape == (8, 5)


def test_rrf_zero_score_quirk_is_reproduced():
    """Reference fault kept on purpose (ROADMAP queue 3): on the scatter
    path, a query with no postings still fills its sparse top-C with
    zero-score docs 0, 1, 2, ... and they earn RRF mass; at 2 and 4
    shards each shard fills its own list from its base, and the merge
    keeps shard 0's first, as in the reference at the same S."""
    docs, ids, w, q_emb, weights = _inputs(600)
    for n_shards in (1, 2, 4):
        mesh = make_mesh(n_shards)
        jidx = jsh.ShardedIndex.from_embeddings(docs, mesh)
        ref = jsh.sharded_hybrid_search(
            jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q_emb),
            jnp.asarray(weights), mesh=mesh, k=5, c=10, n_docs=600,
            mode="rrf",
        )
        tidx = tsh.ShardedIndex.from_embeddings(docs, cpu_mesh(n_shards))
        got = tsh.sharded_hybrid_search(
            tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
            torch.from_numpy(q_emb), torch.from_numpy(weights),
            mesh=tidx.mesh, k=5, c=10, n_docs=600, mode="rrf",
        )
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert {0, 1, 2} <= set(got[1].numpy()[3].tolist())
