"""The BM25 segment sums are exact at a large store: above
``LARGE_N_THRESHOLD`` docs, where ``sparse_mode="auto"`` takes them, with
2**17 postings a query whose running sum passes 10**5 and with negative
weights among them.

- ``_bm25_segment_stats``' totals and ``global_max`` equal
  ``bm25_score_batch``'s bit for bit (both sum in the same 64-bit fixed
  point, so the size of the prefix costs nothing);
- ``sharded_hybrid_search`` gives the same ids and scores through the
  segment sums (``auto``) and the scatter, in both fusion modes;
- each doc's total is within the fixed point's cut (under ``2**-32`` a
  posting) and fp32's one rounding of the float64 sum of its postings;
- on the card, the segment sums replayed in a captured graph equal the
  CPU's eager ones.
"""

import numpy as np
import pytest
import torch

from legal_rag_tpu_torch.ops.dense import LARGE_N_THRESHOLD
from legal_rag_tpu_torch.ops.sparse import FIXED_POINT_BITS, bm25_score_batch
from legal_rag_tpu_torch.parallel import mesh as tmesh
from legal_rag_tpu_torch.parallel.sharded import (
    _bm25_segment_stats, _segment_totals_at, sharded_hybrid_search,
)

N = 70_000
P = 1 << 17
Q = 3
D = 16
SEEDS = (0, 1, 2)


def postings(seed):
    """``[Q, P]`` ids and BM25-sized weights (mean 5, so a row's prefix
    reaches about 6.5e5), some negative, with the gather's padding ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (Q, P)).astype(np.int32)
    w = rng.gamma(2.0, 2.5, (Q, P)).astype(np.float32)
    w[:, ::97] = -rng.uniform(0.05, 0.5, (Q, len(range(0, P, 97))))
    ids[1, P - 5000:] = N                  # the gather's padding id
    w[1, P - 5000:] = 0.0
    ids[2, :3000] = -1                     # foreign padding
    ids[2, 3000:3400] = 17                 # one doc, many postings
    return torch.from_numpy(ids), torch.from_numpy(w)


def test_the_inputs_are_large():
    assert N > LARGE_N_THRESHOLD
    ids, w = postings(SEEDS[0])
    assert float(torch.cumsum(w.double(), 1).max()) > 1e5
    assert bool((w < 0).any())


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_stats_equal_the_scatter_bit_for_bit(seed):
    ids, w = postings(seed)
    sid, valid, totals, gmax = _bm25_segment_stats(ids, w, N)
    dense = bm25_score_batch(ids, w, N)
    for q in range(Q):
        at = sid[q][valid[q]]
        assert torch.equal(totals[q][valid[q]], dense[q][at])
    assert bool((gmax > 0).all())
    assert torch.equal(gmax, dense.max(dim=1).values)
    # every doc's total, docs without postings 0, found by binary search
    probe = torch.arange(N).expand(Q, N).contiguous()
    assert torch.equal(_segment_totals_at(sid, valid, totals, probe), dense)


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_totals_are_the_exact_sum_within_the_cut(seed):
    ids, w = postings(seed)
    sid, valid, totals, _ = _bm25_segment_stats(ids, w, N)
    ids64, w64 = ids.numpy().astype(np.int64), w.numpy().astype(np.float64)
    for q in range(Q):
        keep = (ids64[q] >= 0) & (ids64[q] < N)
        exact = np.zeros(N)
        np.add.at(exact, ids64[q][keep], w64[q][keep])
        got = totals[q][valid[q]].numpy()
        want = exact[sid[q][valid[q]].numpy()]
        # under 2**-32 lost a posting, then fp32's one rounding
        tol = P * 2.0 ** -FIXED_POINT_BITS + np.spacing(np.abs(got))
        assert np.all(np.abs(got - want) <= tol), \
            float(np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_auto_takes_the_segment_sums_and_equals_the_scatter(mode):
    ids, w = postings(SEEDS[1])
    rng = np.random.default_rng(5)
    docs = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    q_emb = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    weights = torch.tensor([0.0, 0.5, 0.9])
    mesh = tmesh.make_mesh(1, device="cpu")
    out = {}
    for sparse_mode in ("auto", "scatter", "segsum"):
        out[sparse_mode] = sharded_hybrid_search(
            docs, ids, w, q_emb, weights, mesh=mesh, k=10, c=20, n_docs=N,
            mode=mode, sparse_mode=sparse_mode)
    for a, b, c in zip(out["auto"], out["scatter"], out["segsum"]):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    if mode == "weighted":
        assert bool((out["auto"][3] > 0).any())     # BM25 took part


@pytest.mark.gpu
def test_segment_sums_replayed_on_the_card_equal_the_cpu():
    """Captured in a graph and replayed on two batches, the card's
    segment totals equal the CPU's eager ones and the scatter's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    from legal_rag_tpu_torch.utils.graphs import GraphSet

    def program(ids, w):
        sid, valid, totals, gmax = _bm25_segment_stats(ids, w, N)
        probe = torch.arange(N, device=ids.device).expand(Q, N).contiguous()
        return (_segment_totals_at(sid, valid, totals, probe), gmax,
                bm25_score_batch(ids, w, N))

    graphs = GraphSet("cuda")
    for seed in SEEDS:
        ids, w = postings(seed)
        got = graphs.run("segsum", program, {"ids": ids.numpy(),
                                             "w": w.numpy()})
        want = program(ids, w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x.numpy())
        np.testing.assert_array_equal(got[0], got[2])
    assert graphs.stats()["graphs"] == 1
