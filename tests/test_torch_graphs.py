"""Serving through captured CUDA graphs (``utils/graphs.py``), and the host
syncs that stood in its way.

On the CPU:

- ``sharded_hybrid_search`` with ``n_queries`` a 0-d tensor against the
  JAX function with ``n_queries`` traced (``pq_interpret=True``, as its
  own tests run it), on the same numpy-seeded inputs: 1, 3 and 8 real
  rows in a bucket of 8, in the fp32, int8, PQ flat and PQ + IVF tiers,
  weighted and RRF, scatter and segment-sum BM25. Ids equal (continuous
  random inputs leave no ties), scores within 1e-5 (fp32 sums in another
  order; the int8 tier's dense scores within 1e-6), as
  tests/test_torch_sharded.py holds them; the tensor equals the int
  bit for bit;
- ``pq_topk`` with a 0-d tensor ``n_valid`` gives the int's result, and
  ``_pq_ivf_topk_impl`` hands it a tensor (no host sync) and equals
  JAX's;
- the kernels' launch bookkeeping for captures and replays, the eager
  path of ``run_program``, and no graphs where there is no card.

On the card (``gpu``): every tier's and mode's replays equal the eager
run of the same engine bit for bit at 1, 5, 8 and 64 real queries; the
A-B-A interleave of two graphs; two threads on one engine; the encoder
and cross-encoder graphs; K1, K1-int8 and K2 launched inside replays; a
capture that fails raises.
"""

import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.ops.pq as jpq
import legal_rag_tpu.parallel.sharded as jsh
from legal_rag_tpu.parallel.mesh import make_mesh
import legal_rag_tpu_torch.ops.pq as tpq
import legal_rag_tpu_torch.parallel.mesh as tmesh
import legal_rag_tpu_torch.parallel.sharded as tsh
from legal_rag_tpu_torch.utils import cuda_build, graphs

N, D, Q, P = 512, 32, 8, 64
K, C = 10, 20
TOL = 1e-5
TIERS = ("float32", "int8", "pq", "ivf")
N_REAL = (1, 3, 8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(83)
    centers = rng.standard_normal((24, D)).astype(np.float32)
    docs = centers[rng.integers(0, 24, N)] + 0.3 * rng.standard_normal(
        (N, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q_emb = rng.standard_normal((Q, D)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    ids = rng.integers(0, N, (Q, P)).astype(np.int32)
    w = rng.gamma(2.0, 1.0, (Q, P)).astype(np.float32)
    ids[1, P // 2:] = N                        # gather padding
    w[1, P // 2:] = 0.0
    ids[5] = N                                 # a padded row: no postings
    w[5] = 0.0
    weights = np.array([0.5, 0.6, 0.0, 0.3, 1.0, 0.0, 0.5, 0.5], np.float32)
    return docs, ids, w, q_emb, weights


@pytest.fixture(scope="module")
def pq_parts(data):
    """Codebooks (OPQ), codes and IVF cells trained by the JAX package."""
    docs = data[0]
    cb = jpq.train_pq(docs, m=8, iters=8, seed=0, opq_iters=2)
    codes = jpq.encode_pq(docs, cb)
    ivf = jpq.build_ivf(docs, cb, codes, cell_size=8, iters=5)
    return cb, codes, ivf


def _indexes(tier, data, pq_parts, jmesh, mesh):
    docs = data[0]
    if tier in ("float32", "int8"):
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


CASES = [(tier, mode, sparse) for tier in TIERS
         for mode in ("weighted", "rrf")
         for sparse in (("segsum",) if tier == "ivf" else ("scatter", "segsum"))]


@pytest.mark.parametrize("n_real", N_REAL)
@pytest.mark.parametrize("tier,mode,sparse_mode", CASES)
def test_tensor_n_queries_matches_jax(data, pq_parts, tier, mode,
                                      sparse_mode, n_real):
    docs, ids, w, q_emb, weights = data
    jmesh, mesh = make_mesh(1), tmesh.Mesh(["cpu"], ("shard",))
    jidx, tidx = _indexes(tier, data, pq_parts, jmesh, mesh)
    q = q_emb if tidx.pq_rotation is None else q_emb @ tidx.pq_rotation
    q = np.ascontiguousarray(q, np.float32)
    kw = dict(k=K, c=C, n_docs=N, mode=mode, sparse_mode=sparse_mode,
              ivf_probes=4, ivf_cell_size=jidx.ivf_cell_size or 1024)
    ref = jsh.sharded_hybrid_search(
        jidx.docs, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q),
        jnp.asarray(weights), jidx.doc_scales, jidx.pq_codebooks,
        jidx.ivf_centroids, jidx.ivf_doc_ids, mesh=jmesh,
        pq_interpret=True, n_queries=jnp.int32(n_real), **kw,
    )
    args = (tidx.docs, torch.from_numpy(ids), torch.from_numpy(w),
            torch.from_numpy(q), torch.from_numpy(weights), tidx.doc_scales,
            tidx.pq_codebooks, tidx.ivf_centroids, tidx.ivf_doc_ids)
    got = tsh.sharded_hybrid_search(
        *args, mesh=mesh, n_queries=torch.tensor(n_real), **kw)
    as_int = tsh.sharded_hybrid_search(*args, mesh=mesh, n_queries=n_real,
                                       **kw)
    f, i, sem, key = (x.numpy() for x in got)
    rf, ri, rsem, rkey = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(i, ri)
    # the fused score carries the BM25 part, summed in another order
    np.testing.assert_allclose(f, rf, atol=TOL, rtol=0)
    np.testing.assert_allclose(sem, rsem, atol=1e-6 if tier == "int8"
                               else TOL, rtol=0)
    np.testing.assert_allclose(key, rkey, atol=TOL, rtol=0)
    for a, b in zip(got, as_int):
        assert torch.equal(a, b)


def test_ivf_votes_follow_the_tensor_n_queries(data, pq_parts):
    """The padded rows' votes move the shared probe set: the real rows'
    results at n_queries 1 differ from those with all 8 rows voting, as
    in the JAX package (so the tensor is read, not ignored)."""
    docs, ids, w, q_emb, weights = data
    mesh = tmesh.Mesh(["cpu"], ("shard",))
    _, tidx = _indexes("ivf", data, pq_parts, make_mesh(1), mesh)
    q = torch.from_numpy(np.ascontiguousarray(q_emb @ tidx.pq_rotation,
                                              np.float32))
    out = {n: tsh.sharded_hybrid_search(
        tidx.docs, torch.from_numpy(ids), torch.from_numpy(w), q,
        torch.from_numpy(weights), None, tidx.pq_codebooks,
        tidx.ivf_centroids, tidx.ivf_doc_ids, mesh=mesh, k=K, c=C, n_docs=N,
        ivf_probes=2, ivf_cell_size=8, n_queries=torch.tensor(n))[1]
        for n in (1, 8)}
    assert not torch.equal(out[1][0], out[8][0])


@pytest.mark.parametrize("n,n_valid,k", [
    (2000, 1700, 10), (2000, 1701, 25), (777, 777, 20), (777, 5000, 20),
])
def test_pq_topk_takes_a_tensor_n_valid(n, n_valid, k):
    rng = np.random.default_rng(5)
    docs = rng.standard_normal((n, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    cb = jpq.train_pq(docs, m=8, iters=4, seed=0)
    codes = torch.from_numpy(jpq.encode_pq(docs, cb))
    q = torch.from_numpy(docs[:6] + 0.1 * rng.standard_normal(
        (6, D)).astype(np.float32))
    cbs = torch.from_numpy(cb.codebooks)
    want = tpq.pq_topk(q, codes, cbs, k, n_valid=n_valid)
    got = tpq.pq_topk(q, codes, cbs, k, n_valid=torch.tensor(n_valid))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[1][torch.isfinite(got[0])] < min(n, n_valid)).all())


def test_pq_ivf_impl_keeps_n_valid_on_the_device(pq_parts, data,
                                                 monkeypatch):
    """``_pq_ivf_topk_impl`` passes the probed cells' valid count to
    ``pq_topk`` as a 0-d tensor (the reference keeps it traced) and
    still equals the JAX function."""
    cb, _, ivf = pq_parts
    q = np.ascontiguousarray(cb.rotate(data[3]), np.float32)
    seen = []
    pq_topk = tpq.pq_topk

    def recording(*a, n_valid=None, **kw):
        seen.append(n_valid)
        return pq_topk(*a, n_valid=n_valid, **kw)

    monkeypatch.setattr(tpq, "pq_topk", recording)
    got_s, got_i = tpq._pq_ivf_topk_impl(
        torch.from_numpy(q), torch.from_numpy(ivf.centroids),
        torch.from_numpy(ivf.codes), torch.from_numpy(ivf.doc_ids),
        torch.from_numpy(cb.codebooks), K, 6, ivf.cell_size)
    ref_s, ref_i = jpq._pq_ivf_topk_impl(
        jnp.asarray(q), jnp.asarray(ivf.centroids), jnp.asarray(ivf.codes),
        jnp.asarray(ivf.doc_ids), jnp.asarray(cb.codebooks), K, 6,
        ivf.cell_size, True)
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert seen[0].dim() == 0
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=TOL,
                               rtol=0)


def test_bm25_scatter_is_order_free():
    """The fixed-point scatter gives the same fp32 scores whatever order
    the postings come in (as the card's atomics take them): each the
    exact sum of the weights cut to 2**-32, rounded once to fp32, within
    an fp32 step of the float64 sum; negative weights included."""
    from legal_rag_tpu_torch.ops.sparse import FIXED_POINT_BITS, bm25_score_batch

    rng = np.random.default_rng(9)
    ids = rng.integers(0, 40, (4, 300)).astype(np.int32)
    ids[1, ::7] = 40                             # padding drops
    w = (rng.gamma(2.0, 1.0, (4, 300)) * rng.choice([-1, 1], (4, 300))
         ).astype(np.float32)
    got = bm25_score_batch(torch.from_numpy(ids), torch.from_numpy(w), 40)
    perm = rng.permutation(300)
    shuffled = bm25_score_batch(torch.from_numpy(ids[:, perm].copy()),
                                torch.from_numpy(w[:, perm].copy()), 40)
    assert torch.equal(got, shuffled)
    scale = 2.0 ** FIXED_POINT_BITS
    fixed = np.trunc(w.astype(np.float64) * scale).astype(np.int64)
    exact = np.zeros((4, 41), np.int64)
    exact64 = np.zeros((4, 41))
    for r in range(4):
        np.add.at(exact[r], ids[r], fixed[r])
        np.add.at(exact64[r], ids[r], w[r].astype(np.float64))
    want = (exact[:, :40] / scale).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), exact64[:, :40], rtol=1.2e-7,
                               atol=1e-8)


# -- the bookkeeping, on the CPU -------------------------------------------


class _Counted(cuda_build.CudaKernel):
    COUNTERS = ("launches", "wide_launches")

    def __init__(self):
        super().__init__("counted", "none.cu", {})
        self.wide_launches = 0


def test_capture_deltas_move_to_the_replay_counts():
    kernel = _Counted()
    try:
        assert kernel in cuda_build.KERNELS
        assert kernel.in_replays == {"launches": 0, "wide_launches": 0}
        kernel.launches, kernel.wide_launches = 5, 2
        before = kernel.counts()
        kernel.launches += 2             # what a capture records
        kernel.wide_launches += 1
        delta = {n: v - before[n] for n, v in kernel.counts().items()}
        kernel.uncount(delta)
        assert kernel.counts() == before
        for _ in range(3):
            kernel.count_replays(delta)
        assert kernel.in_replays == {"launches": 6, "wide_launches": 3}
        kernel.reset_counts()
        assert kernel.counts() == {"launches": 0, "wide_launches": 0}
        assert kernel.in_replays == {"launches": 0, "wide_launches": 0}
    finally:
        cuda_build.KERNELS.remove(kernel)


class _StubLibrary:
    """A loaded kernel library whose every entry point returns ``err``."""

    def __init__(self, err):
        self.calls = []
        self.err = err

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.err


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("kind", ["plain", "segmax_rm"])
def test_launch_raises_on_a_cuda_error_and_counts_only_success(kind, err):
    """``CudaKernel.launch``: an entry point that returns 0 counts one
    launch (through the kernel's own ``count_launch``, with the
    wrapper's keywords); one that returns a CUDA error raises with the
    kernel's name and counts nothing."""
    from legal_rag_tpu_torch.ops.segmax_rm import SegmaxKernel

    kernel = _Counted() if kind == "plain" else SegmaxKernel()
    counts = {} if kind == "plain" else {"int8": True, "tensor_cores": True}
    try:
        kernel._lib = _StubLibrary(err)
        before = kernel.counts()
        if err:
            with pytest.raises(RuntimeError, match=(
                    f"^{kernel.name} kernel launch failed: CUDA error 700$")):
                kernel.launch("some_launch", 1, 2, **counts)
        else:
            kernel.launch("some_launch", 1, 2, **counts)
        assert kernel._lib.calls == [("some_launch", (1, 2))]
        added = {n: v - before[n] for n, v in kernel.counts().items()}
        want = dict.fromkeys(added, 0)
        if not err:
            want.update({"launches": 1} if kind == "plain" else
                        {"int8_launches": 1, "tensor_core_launches": 1})
        assert added == want
    finally:
        cuda_build.KERNELS.remove(kernel)


def test_every_kernel_is_listed_with_its_counters():
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_rm import K1

    assert K1 in cuda_build.KERNELS and K2 in cuda_build.KERNELS
    assert set(K1.in_replays) == {"launches", "int8_launches",
                                  "tensor_core_launches"}
    assert set(K2.in_replays) == {"launches"}


def test_run_program_runs_eagerly_without_graphs():
    calls = []

    def fn(x, n):
        calls.append((x.device.type, x.dtype, tuple(x.shape), n.dim()))
        return x * 2, (x < n).sum(dim=1)

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = graphs.run_program(None, ("k", 3), fn,
                             {"x": x, "n": np.asarray(5, np.int64)},
                             torch.device("cpu"))
    np.testing.assert_array_equal(out[0], x * 2)
    np.testing.assert_array_equal(out[1], [4, 1, 0])
    assert all(isinstance(o, np.ndarray) for o in out)
    assert calls == [("cpu", torch.float32, (3, 4), 0)]


def test_graph_set_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphSet("cpu")


def test_cpu_engine_runs_op_by_op():
    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    cfg = EncoderConfig(hidden=96, layers=1, heads=4, intermediate=96,
                        max_len=32)
    store = synthesize_store(600, seed=3, planted=["punishment for robbery"],
                             cfg=cfg, vocab_size=2000, device="cpu")
    legal = LegalEngine(store=store, use_llm=False, device="cpu",
                        rerank=True)
    assert legal.engine.graphs is None
    assert legal.engine.encoder.graphs is None
    assert legal.orchestrator.reranker.graphs is None
    rows = legal.engine.search_batch(["punishment for robbery"], k=3)
    assert rows[0][0].chunk["canonical_header"] == "PLANTED 0"


# -- on the card -----------------------------------------------------------

GPU_TIERS = ("float32", "bfloat16", "int8", "pq", "ivf")
GPU_N_REAL = (1, 5, 8, 64)
FORCED = 2048       # the two-phase dispatch forced down, so K1 runs


@pytest.fixture(scope="module")
def gpu_engines():
    """One engine per tier over an 8,192-doc synthetic store on the
    card, the two-phase dense path forced (K1 and K1-int8 launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and kernels K1/K2 "
                    "have no CPU mode")
    import dataclasses

    from legal_rag_tpu_torch.config import DEFAULT_CONFIG
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    mp = pytest.MonkeyPatch()
    mp.setattr(tsh, "TWOPHASE_MIN_DOCS", FORCED)
    mp.setattr(tsh, "TWOPHASE_BLOCK_N", FORCED)
    store = synthesize_store(8192, seed=5, planted=QUERIES[:3],
                             device="cuda")
    out = {}
    for tier in GPU_TIERS:
        dense = dataclasses.replace(
            DEFAULT_CONFIG.dense, dtype="pq" if tier == "ivf" else tier,
            use_ivf=tier == "ivf")
        cfg = dataclasses.replace(DEFAULT_CONFIG, dense=dense)
        legal = LegalEngine(store=store, config=cfg, use_llm=False,
                            device="cuda", rerank=tier == "float32")
        legal.engine.graphs.check_syncs = True
        out[tier] = legal
    assert out["ivf"].engine.index.ivf_centroids is not None
    assert out["pq"].engine.index.ivf_centroids is None
    yield out
    mp.undo()


QUERIES = ("punishment for robbery", "What is the procedure to file an FIR?",
           "rights of the victim of an assault", "bail for the accused",
           "compensation scheme for victims")


def _batch(n):
    return [f"{QUERIES[i % len(QUERIES)]} {i}" for i in range(n)]


def _rows(results):
    return [[(r.doc_id, r.score, r.semantic, r.keyword) for r in row]
            for row in results]


def _search(engine, queries, mode, use_graphs):
    engine.graphs.enabled = use_graphs
    try:
        return _rows(engine.search_batch(queries, k=10, mode=mode))
    finally:
        engine.graphs.enabled = True


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["weighted", "rrf"])
@pytest.mark.parametrize("tier", GPU_TIERS)
def test_replays_equal_eager_bit_for_bit(gpu_engines, tier, mode):
    engine = gpu_engines[tier].engine
    for n in GPU_N_REAL:
        queries = _batch(n)
        graph = _search(engine, queries, mode, True)
        again = _search(engine, queries, mode, True)
        eager = _search(engine, queries, mode, False)
        assert graph == eager == again, (tier, mode, n)
    keys = [k for k in engine.graphs.programs if k[0] == "search"]
    assert {8, 64} <= {k[1] for k in keys if k[5] == mode}


@pytest.mark.gpu
def test_graphs_interleaved_keep_their_outputs(gpu_engines):
    """A, B, A on one graph set (the pool is shared): each replay's
    results equal the eager run's."""
    engine = gpu_engines["float32"].engine
    a, b = _batch(3), _batch(40)
    want_a = _search(engine, a, "weighted", False)
    want_b = _search(engine, b, "rrf", False)
    for queries, mode, want in ((a, "weighted", want_a), (b, "rrf", want_b),
                                (a, "weighted", want_a), (b, "rrf", want_b)):
        assert _search(engine, queries, mode, True) == want


@pytest.mark.gpu
def test_two_threads_on_one_engine(gpu_engines):
    """Two threads hammer one engine's graphs (as HTTP workers do with
    coalescing off); every result equals the eager one."""
    engine = gpu_engines["int8"].engine
    work = [(_batch(n), mode) for n in (1, 5, 8, 20)
            for mode in ("weighted", "rrf")]
    want = [_search(engine, q, m, False) for q, m in work]
    engine.graphs.check_syncs = False     # process-wide: not for threads
    bad, done = [], []

    def hammer(order):
        for _ in range(6):
            for j in order:
                q, m = work[j]
                if _rows(engine.search_batch(q, k=10, mode=m)) != want[j]:
                    bad.append(j)
        done.append(1)

    threads = [threading.Thread(target=hammer, args=(order,)) for order in
               (range(len(work)), reversed(range(len(work))))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        engine.graphs.check_syncs = True
    assert len(done) == 2 and not bad


@pytest.mark.gpu
def test_encoder_and_cross_encoder_replay_their_forwards(gpu_engines):
    legal = gpu_engines["float32"]
    engine, ce = legal.engine, legal.orchestrator.reranker
    assert engine.encoder.graphs is engine.graphs is ce.graphs
    texts = _batch(13)
    emb = engine.encoder.encode(texts)
    ce_scores = ce.score_pairs(texts, texts[::-1])
    engine.graphs.enabled = False
    try:
        emb_eager = engine.encoder.encode(texts)
        ce_eager = ce.score_pairs(texts, texts[::-1])
    finally:
        engine.graphs.enabled = True
    assert np.array_equal(emb, emb_eager)
    assert np.array_equal(ce_scores, ce_eager)
    kinds = {k[0] for k in engine.graphs.programs}
    assert {"encode", "cross_encode"} <= kinds
    answer = legal.query(QUERIES[0])
    assert answer["context_used"]


@pytest.mark.gpu
def test_kernels_launch_inside_replays(gpu_engines):
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_rm import K1

    for tier, kernel, counter in (("float32", K1, "launches"),
                                  ("int8", K1, "int8_launches"),
                                  ("pq", K2, "launches"),
                                  ("ivf", K2, "launches")):
        engine = gpu_engines[tier].engine
        queries = _batch(7)
        engine.search_batch(queries, k=10, mode="rrf")    # captured
        K1.reset_counts()
        K2.reset_counts()
        for _ in range(3):
            engine.search_batch(queries, k=10, mode="rrf")
        assert kernel.counts()[counter] == 0, tier
        assert kernel.in_replays[counter] == 3, tier


@pytest.mark.gpu
def test_a_capture_that_fails_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    x = np.ones((4, 8), np.float32)

    def syncs(x):
        n = int(x.sum().item())             # a host sync in the program
        return (x * n,)

    for check_syncs in (False, True):
        gs = graphs.GraphSet("cuda", check_syncs=check_syncs)
        with pytest.raises(RuntimeError):
            gs.run(("sync",), syncs, {"x": x})
        assert not gs.programs
    gs = graphs.GraphSet("cuda")
    (out,) = gs.run(("ok",), lambda x: (x * 2,), {"x": x})
    np.testing.assert_array_equal(out, x * 2)
