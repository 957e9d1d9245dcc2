"""The rest of the BM25 ``ops`` API: the device postings gather and
``bm25_topk``, the port against the JAX package on the same CSR, and
the port's ``ops`` exports against the reference's.

The gather moves values without arithmetic beyond one multiply by an
integer multiplicity, so its output is compared exactly, slot for slot.
Scores of the same postings compare at atol 1e-5 (fp32 sums in another
order); top-k ids are exact (well-separated synthetic scores, and ties
by lowest id in both).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.ops as jax_ops
from legal_rag_tpu.ops.sparse import (
    bm25_gather_postings_device as jax_gather, bm25_topk as jax_bm25_topk,
)
import legal_rag_tpu_torch.ops as ops
from legal_rag_tpu_torch.ops.sparse import (
    bm25_gather_postings_device, bm25_score_batch, bm25_topk, build_bm25,
)

QUERIES = ["the police fir", "w1 w2 w3 w5 w5", "w100", "zzz unknown",
           "the of the of police"]


@pytest.fixture(scope="module")
def bm25(corpus_texts):
    return build_bm25(corpus_texts)


def _both(bm25, queries, budget, max_terms=None):
    meta = bm25.query_term_meta(queries, max_terms)
    ref = jax_gather(*(jnp.asarray(m) for m in meta),
                     jnp.asarray(bm25.doc_ids), jnp.asarray(bm25.weights),
                     budget)
    got = bm25_gather_postings_device(
        *(torch.from_numpy(m) for m in meta),
        torch.from_numpy(bm25.doc_ids), torch.from_numpy(bm25.weights),
        budget)
    return meta, got, tuple(np.asarray(r) for r in ref)


@pytest.mark.parametrize("budget_of", ["exact", "wide", "overflow"])
def test_device_gather_matches_jax(bm25, budget_of):
    need = bm25.postings_budget(QUERIES)
    budget = {"exact": need, "wide": 4 * need, "overflow": need // 8}[budget_of]
    (starts, lens, counts), (ids, w), (r_ids, r_w) = _both(
        bm25, QUERIES, budget)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    assert ids.shape == w.shape == (len(QUERIES), budget)
    np.testing.assert_array_equal(ids.numpy(), r_ids)
    np.testing.assert_array_equal(w.numpy(), r_w)
    total = lens.sum(axis=1)
    for qi in range(len(QUERIES)):
        # slots past a query's postings are (-1, 0.0)
        used = min(int(total[qi]), budget)
        assert (ids[qi, used:] == -1).all() and (w[qi, used:] == 0).all()
        # the slots that are kept are the first postings in term order
        want_ids, want_w = [], []
        for t in range(starts.shape[1]):
            lo, n = int(starts[qi, t]), int(lens[qi, t])
            want_ids += bm25.doc_ids[lo:lo + n].tolist()
            want_w += (bm25.weights[lo:lo + n] * counts[qi, t]).tolist()
        assert ids[qi, :used].tolist() == want_ids[:used]
        np.testing.assert_array_equal(w[qi, :used].numpy(),
                                      np.float32(want_w[:used]))
    if budget_of == "overflow":
        assert (total > budget).any()


def test_device_gather_equals_host_gather_within_budget(bm25):
    """Where the budget does not overflow, the device gather scores as
    the host gather does (slot order may differ)."""
    budget = bm25.postings_budget(QUERIES)
    h_ids, h_w = bm25.gather_postings(QUERIES, budget)
    _, (d_ids, d_w), _ = _both(bm25, QUERIES, budget)
    s_host = bm25_score_batch(torch.from_numpy(h_ids), torch.from_numpy(h_w),
                              bm25.n_docs)
    s_dev = bm25_score_batch(d_ids, d_w, bm25.n_docs)
    torch.testing.assert_close(s_dev, s_host, rtol=1e-5, atol=1e-6)
    for qi in range(len(QUERIES)):
        keep = h_ids[qi] < bm25.n_docs
        assert sorted(zip(h_ids[qi][keep].tolist(), h_w[qi][keep].tolist())) \
            == sorted(zip(d_ids[qi][d_ids[qi] >= 0].tolist(),
                          d_w[qi][d_ids[qi] >= 0].tolist()))


def test_device_gather_term_slots_past_max_terms(bm25):
    """Term metadata padded with zero-length slots, and a query with
    more distinct terms than ``max_terms`` (the rest drop)."""
    many = " ".join(f"w{i}" for i in range(1, 12))
    meta, (ids, w), (r_ids, r_w) = _both(bm25, [many, "w100"], 256,
                                         max_terms=6)
    np.testing.assert_array_equal(ids.numpy(), r_ids)
    np.testing.assert_array_equal(w.numpy(), r_w)
    assert int((ids[0] >= 0).sum()) == int(meta[1][0].sum())


@pytest.mark.parametrize("k", [1, 7, 97])
def test_bm25_topk_matches_jax(bm25, k):
    budget = bm25.postings_budget(QUERIES)
    h_ids, h_w = bm25.gather_postings(QUERIES, budget)
    rs, ri = jax_bm25_topk(jnp.asarray(h_ids), jnp.asarray(h_w),
                           bm25.n_docs, k)
    s, i = bm25_topk(torch.from_numpy(h_ids), torch.from_numpy(h_w),
                     bm25.n_docs, k)
    assert i.dtype == torch.int32 and s.shape == (len(QUERIES), k)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5, rtol=0)
    # queries without postings tie every doc at 0: lowest ids first
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i[3].tolist() == list(range(k))


def test_ops_exports_the_reference_api():
    """The port's ``ops`` holds the reference's names, with its own
    names for the dense backends (``dense_topk_xla`` / ``_pallas`` are
    ``dense_topk_matmul`` / ``_fused``)."""
    renamed = {"dense_topk_xla": "dense_topk_matmul",
               "dense_topk_pallas": "dense_topk_fused"}
    want = [renamed.get(n, n) for n in jax_ops.__all__]
    assert ops.__all__ == want
    for name in want:
        assert getattr(ops, name).__module__.startswith("legal_rag_tpu_torch.")
