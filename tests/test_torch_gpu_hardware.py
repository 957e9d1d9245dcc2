"""Hardware checks of the PyTorch port on a CUDA card, the counterpart of
tests/test_tpu_hardware.py: each check there runs here through the
port's hand-written kernels (compiled by nvcc, not their plain
versions). Skipped without a card; run on one with

    python -m pytest tests/test_torch_gpu_hardware.py -m gpu -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_argmax_probe_takes_the_lowest_index(cuda):
    """Row P: the toolchain builds and launches a kernel, and its row
    reduction by (max, lowest index) resolves the tie at 33 and 200 to
    33, the rule K3's selection uses (the TPU's argmax took the last)."""
    from legal_rag_tpu_torch.ops.argmax_probe import P, probe_input, row_argmax

    before = P.launches
    got = row_argmax(probe_input(cuda))
    torch.cuda.synchronize()
    assert P.launches == before + 1
    assert got.tolist() == [33] * 8


def test_launch_path_counts_each_launch_and_raises_on_mixed_devices(cuda):
    """The lean launch path shared by every wrapper: one count per
    launch and none for a CPU tensor (its plain version), a launch on a
    side stream lands there, and tensors on two devices raise."""
    from legal_rag_tpu_torch.ops.argmax_probe import P, probe_input, row_argmax
    from legal_rag_tpu_torch.ops.fused_topk import fused_topk

    x = probe_input(cuda)
    before = P.launches
    for _ in range(5):
        row_argmax(x)
    assert P.launches == before + 5
    assert row_argmax(x.cpu()).tolist() == [33] * 8
    assert P.launches == before + 5
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = row_argmax(x)
    side.synchronize()
    assert got.tolist() == [33] * 8 and P.launches == before + 6
    with pytest.raises(ValueError, match="CUDA"):
        row_argmax(torch.empty((8, 256), device="meta"))
    docs_t = torch.ones((16, 300), device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_topk(torch.ones((2, 16)), docs_t, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_topk(torch.ones((2, 16), device=cuda), docs_t.cpu(), 5)


def test_fused_kernel_tie_break_on_hardware(cuda):
    """Duplicate docs order by ascending id through K3."""
    from legal_rag_tpu_torch.ops.dense import dense_topk_fused
    from legal_rag_tpu_torch.ops.fused_topk import K3

    docs = np.concatenate([np.ones((6, 8), np.float32),
                           np.zeros((2, 8), np.float32)])
    q = torch.ones((1, 8), device=cuda)
    before = K3.launches
    _, i = dense_topk_fused(q, torch.from_numpy(docs.T.copy()).to(cuda), 4)
    assert K3.launches == before + 1
    assert i[0].tolist() == [0, 1, 2, 3]


def test_hybrid_search_end_to_end_on_card(cuda):
    """The one-card sharded hybrid search (S=1) on the card: recall against an
    exact golden."""
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    rng = np.random.default_rng(0)
    n, d, q, k = 5000, 128, 16, 10
    docs = _unit(rng, n, d)
    qe = rng.standard_normal((q, d)).astype(np.float32)
    idx = ShardedIndex.from_embeddings(docs, device=cuda)
    pi = torch.full((q, 64), n, dtype=torch.int32, device=cuda)
    pw = torch.zeros((q, 64), device=cuda)
    _, ids, _, _ = sharded_hybrid_search(
        idx.docs, pi, pw, torch.from_numpy(qe).to(cuda),
        torch.zeros(q, device=cuda), mesh=idx.mesh, k=k, c=2 * k, n_docs=n,
        mode="weighted",
    )
    gold = np.argsort(-(qe @ docs.T), axis=1)[:, :k]
    ids = ids.cpu().numpy()
    rec = np.mean([len(set(ids[i]) & set(gold[i])) / k for i in range(q)])
    assert rec >= 0.999


def test_twophase_kernel_on_card(cuda):
    """The column-major two-phase search around K4: exact golden parity
    at seg_rows=16."""
    from legal_rag_tpu_torch.ops.dense import dense_topk_twophase
    from legal_rag_tpu_torch.ops.segmax_cm import K4

    rng = np.random.default_rng(1)
    n, d, q, k = 40000, 128, 16, 10
    docs = _unit(rng, n, d)
    qe = rng.standard_normal((q, d)).astype(np.float32)
    before = K4.launches
    _, i = dense_topk_twophase(
        torch.from_numpy(qe).to(cuda),
        torch.from_numpy(docs.T.copy()).to(cuda), k, seg_rows=16)
    assert K4.launches == before + 1
    gold = np.argsort(-(qe.astype(np.float64) @ docs.T.astype(np.float64)),
                      axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i.cpu().numpy(), gold)


def test_int8_rescore_on_card(cuda):
    """int8 index (K1-int8) + fp32 rescore restores exact ordering."""
    from legal_rag_tpu_torch.ops.dense import exact_rescore
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    rng = np.random.default_rng(2)
    base = rng.standard_normal((64, 64)).astype(np.float32)
    docs = np.repeat(base, 8, axis=0) + 1e-3 * rng.standard_normal(
        (512, 64)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qe = _unit(rng, 8, 64)
    idx = ShardedIndex.from_embeddings(docs, dtype="int8", device=cuda)
    n, k = 512, 10
    pi = torch.full((8, 8), n, dtype=torch.int32, device=cuda)
    pw = torch.zeros((8, 8), device=cuda)
    w = np.zeros(8, np.float32)
    _, ids8, _, key8 = sharded_hybrid_search(
        idx.docs, pi, pw, torch.from_numpy(qe).to(cuda),
        torch.from_numpy(w).to(cuda), idx.doc_scales, mesh=idx.mesh, k=4 * k, c=8 * k,
        n_docs=n, mode="weighted",
    )
    _, ids, _, _ = exact_rescore(qe, ids8.cpu().numpy(), docs,
                                 keyword=key8.cpu().numpy(), weights=w, k=k)
    gold = np.argsort(-(qe.astype(np.float64) @ docs.T.astype(np.float64)),
                      axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids, gold)


def test_pq_kernel_on_card(cuda):
    """K2 through pq_topk: the phase-2 fp32 rescore orders nearly every
    row exactly like the nibble-table golden (bf16 tables only pick
    segments in phase 1)."""
    from legal_rag_tpu_torch.ops.pq import (
        encode_pq, pq_topk, train_pq, unpack_codes,
    )
    from legal_rag_tpu_torch.ops.pq_segmax import K2

    rng = np.random.default_rng(11)
    d, m, n = 64, 8, 6000
    centers = rng.standard_normal((50, d)).astype(np.float32)
    docs = centers[rng.integers(0, 50, n)] + 0.15 * rng.standard_normal((n, d))
    docs = (docs / np.linalg.norm(docs, axis=1, keepdims=True)).astype(np.float32)
    q = docs[rng.integers(0, n, 8)].copy()
    cb = train_pq(docs, m=m, iters=10, seed=0, device=cuda)
    codes = encode_pq(docs, cb, device=cuda)
    before = K2.launches
    s, ids = pq_topk(torch.from_numpy(cb.rotate(q)).to(cuda),
                     torch.from_numpy(codes).to(cuda),
                     torch.from_numpy(cb.codebooks).to(cuda), 10)
    assert K2.launches > before
    s, ids = s.cpu().numpy(), ids.cpu().numpy()
    nibs = unpack_codes(codes)
    lut = np.einsum("qmd,mcd->qmc",
                    cb.rotate(q).reshape(8, cb.n_subspaces, cb.dsub),
                    cb.codebooks)
    golden = np.zeros((8, n), np.float32)
    for sub in range(cb.n_subspaces):
        golden += lut[np.arange(8)[:, None], sub, nibs[None, :, sub]]
    exact = sum(
        int((ids[qi] == np.lexsort((np.arange(n), -golden[qi]))[:10]).all())
        for qi in range(8)
    )
    max_rel = np.max(np.abs(s - np.take_along_axis(golden, ids, 1))
                     / (np.abs(s) + 1e-6))
    assert exact >= 7, exact
    assert max_rel < 1e-3, max_rel
