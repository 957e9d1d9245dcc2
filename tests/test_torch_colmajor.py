"""The column-major dense backends of the port against the JAX package:
``dense_topk_fused`` (kernel K3's plain version on the CPU) against
``dense_topk_pallas(interpret=True)``, ``dense_topk_twophase`` (K4's
plain version) against JAX's ``dense_topk_twophase(interpret=True)``,
and ``dense_topk`` against ``legal_rag_tpu.ops.dense_topk``, on the cases
of tests/test_dense.py and a few more: the masked tail when
``n_valid < k``, K4's segment map, the bench script at a tiny size.

Tolerance: scores within rtol 1e-5 and atol 1e-5 (both sides sum fp32
products in another order); ids under the tie-aware rule of
tests/test_dense.py, and exactly equal where ties are made on purpose.
The GPU cases at the end hold each kernel against its plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.ops as jops
import legal_rag_tpu.ops.dense as jdense
import legal_rag_tpu_torch.ops as tops
from legal_rag_tpu_torch.ops import fused_topk as k3
from legal_rag_tpu_torch.ops import segmax_cm as k4
from legal_rag_tpu_torch.ops.dense import dense_topk_fused, dense_topk_twophase

TOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def golden_topk(queries, docs, k):
    """float64 scores, descending, ties by ascending id."""
    s = queries.astype(np.float64) @ docs.T.astype(np.float64)
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, axis=1), ids


def assert_topk_equiv(queries, docs, k, got_s, got_i):
    """Tie-aware exact top-k against float64 (tests/test_dense.py)."""
    s64 = queries.astype(np.float64) @ docs.T.astype(np.float64)
    for qi in range(queries.shape[0]):
        srt = np.sort(s64[qi])[::-1]
        kth = srt[k - 1]
        np.testing.assert_allclose(got_s[qi], srt[:k], rtol=TOL, atol=TOL)
        assert (np.diff(got_s[qi]) <= TOL).all()
        got_true = s64[qi, got_i[qi]]
        np.testing.assert_allclose(got_s[qi], got_true, rtol=TOL, atol=TOL)
        assert set(np.where(s64[qi] > kth + TOL)[0]) <= set(got_i[qi])
        assert (got_true >= kth - TOL).all()


def assert_same(queries, docs, k, got, ref):
    """The port's result and JAX's: both exact top-k under the tie-aware
    rule, scores equal within the tolerance."""
    got_s, got_i = (x.numpy() for x in got)
    ref_s, ref_i = (np.asarray(x) for x in ref)
    assert got_s.dtype == np.float32 and got_i.dtype == np.int32
    assert got_s.shape == ref_s.shape == (queries.shape[0], k)
    assert_topk_equiv(queries, docs, k, got_s, got_i)
    assert_topk_equiv(queries, docs, k, ref_s, ref_i)
    np.testing.assert_allclose(got_s, ref_s, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return _unit(rng, 13, 384), _unit(rng, 1000, 384)


# -- K3: dense_topk_fused against dense_topk_pallas --------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_jax_golden(data, dtype):
    queries, docs = data
    ref = jdense.dense_topk_pallas(
        jnp.asarray(queries, dtype), jnp.asarray(docs.T, dtype), 10,
        block_n=256, interpret=True,
    )
    got = dense_topk_fused(_t(queries).to(getattr(torch, dtype)),
                           _t(docs.T).to(getattr(torch, dtype)), 10)
    if dtype == "bfloat16":   # compare against the bf16-rounded inputs
        queries = np.asarray(jnp.asarray(queries, dtype), np.float32)
        docs = np.asarray(jnp.asarray(docs, dtype), np.float32)
    assert_same(queries, docs, 10, got, ref)


def test_fused_ragged_shapes():
    """N and Q not multiples of any tile."""
    rng = np.random.default_rng(3)
    docs = rng.standard_normal((333, 64)).astype(np.float32)
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    ref = jdense.dense_topk_pallas(jnp.asarray(queries), jnp.asarray(docs.T),
                                   7, block_n=128, interpret=True)
    got = dense_topk_fused(_t(queries), _t(docs.T), 7)
    assert_same(queries, docs, 7, got, ref)


def test_fused_tie_breaking_lowest_id_wins():
    doc = np.ones((1, 8), dtype=np.float32)
    docs = np.concatenate([doc] * 6 + [np.zeros((2, 8), dtype=np.float32)])
    queries = np.ones((1, 8), dtype=np.float32)
    _, ref = jdense.dense_topk_pallas(jnp.asarray(queries), jnp.asarray(docs.T),
                                      4, block_n=128, interpret=True)
    _, got = dense_topk_fused(_t(queries), _t(docs.T), 4)
    assert got[0].tolist() == np.asarray(ref)[0].tolist() == [0, 1, 2, 3]


def test_fused_tie_breaking_across_blocks():
    """Equal scores in three of JAX's 128-column blocks and two of the
    kernel's 256-column tiles keep ascending-id order."""
    docs = np.zeros((300, 8), dtype=np.float32)
    docs[10] = docs[150] = docs[290] = 1.0
    queries = np.ones((1, 8), dtype=np.float32) / np.sqrt(8)
    _, ref = jdense.dense_topk_pallas(jnp.asarray(queries), jnp.asarray(docs.T),
                                      3, block_n=128, interpret=True)
    _, got = dense_topk_fused(_t(queries), _t(docs.T), 3)
    assert got[0].tolist() == np.asarray(ref)[0].tolist() == [10, 150, 290]


def test_fused_k_close_to_n():
    rng = np.random.default_rng(11)
    docs = rng.standard_normal((20, 16)).astype(np.float32)
    queries = rng.standard_normal((2, 16)).astype(np.float32)
    _, gi = golden_topk(queries, docs, 20)
    _, ref = jdense.dense_topk_pallas(jnp.asarray(queries), jnp.asarray(docs.T),
                                      20, block_n=128, interpret=True)
    _, got = dense_topk_fused(_t(queries), _t(docs.T), 20)
    np.testing.assert_array_equal(got.numpy(), gi)
    np.testing.assert_array_equal(np.asarray(ref), gi)


def test_fused_dynamic_n_valid():
    """Columns past n_valid (zero pad docs) cannot evict negative-score
    candidates."""
    rng = np.random.default_rng(5)
    d, n_real, n_padded = 32, 13, 40
    docs_t = np.zeros((d, n_padded), dtype=np.float32)
    real = -np.abs(rng.standard_normal((d, n_real))).astype(np.float32)
    docs_t[:, :n_real] = real / np.linalg.norm(real, axis=0, keepdims=True)
    q = np.abs(_unit(rng, 4, d))
    ref_s, ref_i = jdense.dense_topk_pallas(
        jnp.asarray(q), jnp.asarray(docs_t), 5,
        n_valid=jnp.asarray(n_real, jnp.int32), block_n=128, interpret=True,
    )
    got_s, got_i = dense_topk_fused(_t(q), _t(docs_t), 5, n_valid=n_real)
    golden = np.argsort(-(q.astype(np.float64) @ docs_t[:, :n_real]),
                        axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(got_i.numpy(), golden)
    np.testing.assert_array_equal(np.asarray(ref_i), golden)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n_valid,k", [(5, 12), (0, 4), (17, 20)])
def test_fused_masked_tail_matches_jax(n_valid, k):
    """With n_valid < k the masked columns fill the tail in ascending id
    order at finfo(float32).min, exactly as the TPU kernel returns."""
    rng = np.random.default_rng(9)
    docs = _unit(rng, 20, 16)
    q = _unit(rng, 3, 16)
    ref_s, ref_i = jdense.dense_topk_pallas(
        jnp.asarray(q), jnp.asarray(docs.T), k,
        n_valid=jnp.asarray(n_valid, jnp.int32), block_n=128, interpret=True,
    )
    got_s, got_i = dense_topk_fused(_t(q), _t(docs.T), k, n_valid=n_valid)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)
    tail = got_i.numpy()[:, n_valid:]
    assert (tail == np.arange(n_valid, k)).all()
    assert (got_s.numpy()[:, n_valid:] == np.finfo(np.float32).min).all()


def test_fused_k_above_n_raises():
    with pytest.raises(ValueError, match="k <= N"):
        dense_topk_fused(torch.ones(1, 8), torch.ones(8, 5), 6)


def test_fused_reference_sums_in_kernel_order():
    """The plain version adds each rounded fp32 product in column order,
    so it equals a numpy loop of the same roundings bit for bit."""
    rng = np.random.default_rng(4)
    docs_t = rng.standard_normal((48, 70)).astype(np.float32)
    q = rng.standard_normal((3, 48)).astype(np.float32)
    want = np.zeros((3, 70), np.float32)
    for e in range(48):
        want = want + (q[:, e:e + 1] * docs_t[e]).astype(np.float32)
    s, i = k3.fused_topk_reference(_t(q), _t(docs_t), 70)
    np.testing.assert_array_equal(s.numpy(),
                                  np.take_along_axis(want, i.numpy().astype(np.int64), 1))


def test_fused_cpu_tensors_take_the_plain_version_uncounted():
    before = k3.K3.launches
    dense_topk_fused(torch.ones(2, 16), torch.ones(16, 300), 5)
    assert k3.K3.launches == before


def test_fused_non_cpu_tensors_never_reach_the_plain_version():
    q = torch.empty(8, 384, device="meta")
    d = torch.empty(384, 1024, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3.fused_topk(q, d, 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_launch_plan_fits_every_shape(dtype):
    """For every k in 1..256 and a few past it (shared buffers up to 480,
    device-memory buffers above) and Q in 1..512 (D = 384, 1024, 1536
    and 8200, a small and a 1M corpus): a valid query tile, buffer and
    split count, a block's shared memory within the card's 232,448
    bytes, the queries streamed only where they do not fit at 16, and
    the large-k scratch within 1 GiB."""
    plan = k3.launch_plan.__wrapped__
    for d in (384, 1024, 1536, 8200):
        for n in (300, 1_007_616):
            tiles = -(-n // 128)
            ks = [*range(1, 257, 1 if d <= 1024 else 17), 300, 480, 481, 1024]
            for k in (k for k in ks if k <= n):
                cap = k3.capacity(k)
                assert cap & (cap - 1) == 0 and k + 32 <= cap < 2 * (k + 32)
                for n_q in range(1, 513, 1 if d <= 1024 else 7):
                    p = plan(dtype, d, k, n, n_q, 132)
                    assert p.query_tile in (16, 32, 64)
                    assert p.query_tile >= min(n_q, 16)
                    assert -(-n_q // p.query_tile) <= 65535
                    assert p.cap == cap
                    assert 1 <= p.n_splits <= tiles
                    assert p.smem == k3.smem_bytes(dtype, d, p.query_tile, cap,
                                                   p.stream_q)
                    assert p.smem <= k3.MAX_SMEM == 232_448
                    assert p.stream_q == (k3.smem_bytes(
                        dtype, d, 16, cap) > k3.MAX_SMEM)
                    assert not p.stream_q or p.query_tile == 16
                    if cap > 512:
                        n_qt = -(-n_q // p.query_tile)
                        scratch = p.n_splits * (n_q * k * 8 + n_qt
                                                * p.query_tile * (cap + 1) * 8)
                        assert p.n_splits == 1 or scratch <= 1 << 30


def test_dense_topk_fused_large_k_matches_xla():
    """ops.dense_topk(fused=True) at k = 300 (past the 256 the kernel
    took before) against the JAX dense_topk_xla, which orders as K3 does:
    score descending, ties by lowest id."""
    rng = np.random.default_rng(300)
    docs = _unit(rng, 1200, 48)
    docs[600:610] = docs[5]
    queries = _unit(rng, 6, 48)
    queries[0] = docs[5]
    ref = jdense.dense_topk_xla(jnp.asarray(queries), jnp.asarray(docs), 300)
    got = tops.dense_topk(_t(queries), _t(docs), 300, fused=True)
    assert_same(queries, docs, 300, got, ref)
    assert got[1][0][:11].tolist() == [5, *range(600, 610)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twophase_wide_dim_matches_jax(dtype):
    """dense_topk_twophase at D=1536 (past the 1024 K4 took before)
    against JAX's dense_topk_twophase in interpret mode."""
    rng = np.random.default_rng(1536)
    docs = _unit(rng, 2000, 1536)
    docs[1000:1004] = docs[9]
    queries = _unit(rng, 4, 1536)
    queries[2] = docs[9]
    ref = jdense.dense_topk_twophase(
        jnp.asarray(queries, dtype), jnp.asarray(docs.T, dtype), 10,
        block_n=1024, interpret=True)
    tdt = getattr(torch, dtype)
    got = dense_topk_twophase(_t(queries).to(tdt), _t(docs.T).to(tdt), 10)
    qd = np.asarray(jnp.asarray(queries, dtype), np.float32)
    dd = np.asarray(jnp.asarray(docs, dtype), np.float32)
    assert_same(qd, dd, 10, got, ref)
    assert got[1][2][:5].tolist() == [9, 1000, 1001, 1002, 1003]


@pytest.mark.parametrize("n_q,k", [(64, 10), (64, 256)])
def test_fused_reference_matches_jax_at_wide_q_and_k(n_q, k):
    """K3's plain version against dense_topk_pallas at the kernel's
    widest query tile and largest k."""
    rng = np.random.default_rng(n_q + k)
    docs = _unit(rng, 700, 64)
    docs[650] = docs[3]                 # a duplicate across JAX's blocks
    queries = _unit(rng, n_q, 64)
    queries[0] = docs[3]
    ref = jdense.dense_topk_pallas(jnp.asarray(queries), jnp.asarray(docs.T),
                                   k, block_n=256, interpret=True)
    got = k3.fused_topk_reference(_t(queries), _t(docs.T), k)
    assert_same(queries, docs, k, got, ref)
    assert got[1][0][:2].tolist() == [3, 650]


# -- K4: dense_topk_twophase against JAX's dense_topk_twophase ---------


def test_twophase_matches_jax_golden(data):
    queries, docs = data
    ref = jdense.dense_topk_twophase(jnp.asarray(queries), jnp.asarray(docs.T),
                                     10, interpret=True)
    got = dense_topk_twophase(_t(queries), _t(docs.T), 10)
    assert_same(queries, docs, 10, got, ref)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_twophase_bf16_matches_jax(data):
    queries, docs = data
    ref = jdense.dense_topk_twophase(
        jnp.asarray(queries, jnp.bfloat16), jnp.asarray(docs.T, jnp.bfloat16),
        10, interpret=True)
    got = dense_topk_twophase(_t(queries).bfloat16(), _t(docs.T).bfloat16(), 10)
    qb = np.asarray(jnp.asarray(queries, jnp.bfloat16), np.float32)
    db = np.asarray(jnp.asarray(docs, jnp.bfloat16), np.float32)
    assert_same(qb, db, 10, got, ref)


def test_twophase_duplicate_tie_break():
    rng = np.random.default_rng(13)
    docs = rng.standard_normal((2000, 32)).astype(np.float32)
    docs[50] = docs[700] = docs[1500]          # 3 identical docs
    queries = docs[50:51] * 1.5                # exact tie at the top
    _, ref = jdense.dense_topk_twophase(jnp.asarray(queries),
                                        jnp.asarray(docs.T), 5, interpret=True)
    _, got = dense_topk_twophase(_t(queries), _t(docs.T), 5)
    assert list(got[0][:3].tolist()) == [50, 700, 1500]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_valid", [700, 513])
def test_twophase_dynamic_n_valid(n_valid):
    rng = np.random.default_rng(5)
    n_padded, d = 1024, 32
    docs = np.zeros((n_padded, d), dtype=np.float32)
    real = -np.abs(rng.standard_normal((n_valid, d))).astype(np.float32)
    docs[:n_valid] = real / np.linalg.norm(real, axis=1, keepdims=True)
    q = np.abs(_unit(rng, 4, d))
    ref_s, ref_i = jdense.dense_topk_twophase(
        jnp.asarray(q), jnp.asarray(docs.T), 5,
        n_valid=jnp.asarray(n_valid, jnp.int32), interpret=True,
    )
    got_s, got_i = dense_topk_twophase(_t(q), _t(docs.T), 5, n_valid=n_valid)
    golden = np.argsort(-(q.astype(np.float64) @ docs[:n_valid].T),
                        axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(got_i.numpy(), golden)
    np.testing.assert_array_equal(np.asarray(ref_i), golden)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("seg_rows,block_q", [(1, 8), (4, 16), (8, 8)])
def test_twophase_seg_rows_variants(data, seg_rows, block_q):
    queries, docs = data
    g_s, g_i = golden_topk(queries, docs, 7)
    ref_s, ref_i = jdense.dense_topk_twophase(
        jnp.asarray(queries), jnp.asarray(docs.T), 7, block_n=1024,
        block_q=block_q, seg_rows=seg_rows, interpret=True,
    )
    got_s, got_i = dense_topk_twophase(_t(queries), _t(docs.T), 7,
                                       seg_rows=seg_rows)
    np.testing.assert_array_equal(got_i.numpy(), g_i)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), g_s, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)


def test_twophase_flat_select_matches_jax_two_level(monkeypatch):
    """The port selects segments by one flat top-kk; JAX's two-level
    (super-segment) select, forced here on a small corpus, picks the
    same segments: equal results, duplicate ties across supers
    included."""
    monkeypatch.setattr(jdense, "_TWO_LEVEL_MIN_SEGS", 1)
    rng = np.random.default_rng(11)
    n = 9600                      # seg_rows=1 -> 9600 segs, 75 supers
    docs = _unit(rng, n, 32)
    docs[500] = docs[7000] = docs[9100]
    queries = np.concatenate([docs[9100:9101] * 1.2,
                              rng.standard_normal((3, 32)).astype(np.float32)])
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    ref = jdense.dense_topk_twophase(
        jnp.asarray(queries), jnp.asarray(docs.T), 10, block_n=128,
        block_q=8, seg_rows=1, interpret=True,
    )
    got = dense_topk_twophase(_t(queries), _t(docs.T), 10, seg_rows=1)
    assert_same(queries, docs, 10, got, ref)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1][0][:3].tolist() == [500, 7000, 9100]


@pytest.mark.parametrize("seg_rows,n,n_valid", [
    (1, 300, 300), (4, 1000, 777), (8, 1024, 1024), (16, 2500, 2049),
])
def test_segmax_cm_reference_is_jax_strided_segment_map(seg_rows, n, n_valid):
    """K4's plain map equals a numpy construction of the TPU kernel's:
    segment G*128+lane holds docs G*seg_rows*128 + r*128 + lane, masked
    columns score finfo.min, padding to whole groups of seg_rows*128."""
    rng = np.random.default_rng(seg_rows + n)
    docs_t = rng.standard_normal((24, n)).astype(np.float32)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    group = seg_rows * 128
    n_pad = -(-n // group) * group
    s = np.full((3, n_pad), np.finfo(np.float32).min, np.float32)
    s[:, :n_valid] = q.astype(np.float64) @ docs_t[:, :n_valid]
    want = s.reshape(3, n_pad // group, seg_rows, 128).max(axis=2)
    want = want.reshape(3, -1)
    got = k4.segmax_cm_reference(_t(q), _t(docs_t), n_valid, seg_rows)
    assert got.shape == (3, k4.n_segments(n, seg_rows)) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # phase 2's member ids are the columns each map entry maxes over
    members = k4.segment_members(torch.arange(got.shape[1]), seg_rows)
    np.testing.assert_array_equal(s[:, members.numpy()].max(axis=2), want)


def test_segmax_cm_non_cpu_tensors_never_reach_the_plain_version():
    q = torch.empty(8, 384, device="meta")
    d = torch.empty(384, 1024, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k4.segmax_cm(q, d, 1000, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmax_cm_launch_plan_fits_every_shape(dtype):
    """For every width up to 8,192 and Q in 1..200: the smallest built
    query tile that holds Q, or tiles of 64 (ceil(Q / 64) of them) above
    64, and a block's shared memory within the card's 232,448 bytes, the
    queries resident wherever they fit unless streaming them lets two
    blocks share an SM."""
    elt = dtype.itemsize
    plan = k4.launch_plan.__wrapped__
    assert k4.QUERY_TILES == (8, 16, 32, 64)
    two = k4.TWO_BLOCKS_SMEM
    for d in range(1, 8193):
        for n_q in range(1, 201):
            p = plan(dtype, d, n_q)
            assert p.query_tile == min(t for t in k4.QUERY_TILES
                                       if t >= min(n_q, 64))
            assert -(-n_q // p.query_tile) == -(-n_q // 64)
            assert p.smem == k4.smem_bytes(elt, d, p.query_tile, p.stream_q)
            assert p.smem <= k4.MAX_SMEM == 232_448
            resident = k4.smem_bytes(elt, d, p.query_tile, False)
            streamed = k4.smem_bytes(elt, d, p.query_tile, True)
            assert p.stream_q == (resident > k4.MAX_SMEM or (
                resident > two and streamed <= two))


# -- the dispatcher and the bench --------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_dense_topk_matches_jax_dispatcher(data, fused):
    queries, docs = data
    ref = jops.dense_topk(jnp.asarray(queries), jnp.asarray(docs), 10,
                          use_pallas=fused, block_n=256, interpret=True)
    got = tops.dense_topk(_t(queries), _t(docs), 10, fused=fused)
    assert_same(queries, docs, 10, got, ref)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_ops_exports_the_dense_backends():
    assert set(tops.__all__) == {
        "l2_normalize", "dense_topk", "dense_topk_matmul", "dense_topk_fused",
        "dense_topk_twophase", "dense_topk_twophase_rm",
        # the rest of the reference's ops API
        "BM25Index", "build_bm25", "bm25_score_batch", "bm25_topk",
        "MultiVectorIndex", "maxsim_topk", "weighted_fusion", "rrf_fusion",
    }
    assert tops.dense_topk_fused is dense_topk_fused


def test_bench_scale_on_cpu_is_untimed_and_exact():
    from legal_rag_tpu_torch.scripts import bench_scale

    rows = bench_scale.run([2048, 4096], "cpu", include_cm=True,
                           log=lambda s: None)
    names = [r["name"] for r in rows]
    assert names == ["matmul + top-k", "two-phase rm (K1)",
                     "two-phase cm (K4)"] * 2
    assert all(r["ms"] is None and r["gbps"] is None for r in rows)
    assert all(r["recall"] == 1.0 for r in rows)


# -- the kernels against their plain versions on the card --------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K3 and K4 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seg_rows", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("d,n_q", [(384, 8), (102, 19)])
def test_segmax_cm_kernel_matches_plain_on_gpu(cuda, dtype, seg_rows, d, n_q):
    rng = np.random.default_rng(seg_rows)
    n = 20_000 + 37
    wide = torch.from_numpy(_unit(rng, n + 64, d).T.copy()).to(cuda, dtype)
    docs_t = wide[:, :n]                # a column slice: row stride > N
    docs_t[:, 5000:5040] = docs_t[:, 3:4]
    q = torch.from_numpy(_unit(rng, n_q, d)).to(cuda, dtype)
    before = k4.K4.launches
    for n_valid in (n, n - 3001):
        got = k4.segmax_cm(q, docs_t, n_valid, seg_rows)
        ref = k4.segmax_cm_reference(q, docs_t, n_valid, seg_rows)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (n_q, k4.n_segments(n, seg_rows))
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert k4.K4.launches == before + 2


def assert_topk_tie_aware(scores, k, got_s, got_i, tol=TOL):
    """K3's ``(got_s, got_i)`` against the plain version's fp32 scores
    ``[Q, N]`` (masked columns at finfo.min): values rank by rank and
    each id's own score within ``tol``, descending, ids distinct, every
    column clearly above the k-th present, none clearly below it."""
    s64 = scores.double()
    srt = torch.topk(s64, k, dim=1).values
    kth = srt[:, k - 1:k]
    got_s, got_i = got_s.double(), got_i.long()
    assert got_s.shape == got_i.shape == (scores.shape[0], k)
    assert bool((got_i >= 0).all()) and bool((got_i < scores.shape[1]).all())
    got_true = torch.gather(s64, 1, got_i)
    assert float((got_s - srt).abs().max()) <= tol
    assert float((got_s - got_true).abs().max()) <= tol
    assert bool((got_s[:, 1:] - got_s[:, :-1] <= tol).all())
    assert bool((got_true >= kth - tol).all())
    for qi in range(scores.shape[0]):
        row = got_i[qi].tolist()
        assert len(set(row)) == k
        must = torch.nonzero(s64[qi] > kth[qi] + tol).flatten().tolist()
        assert set(must) <= set(row)


_GPU_N = 65_536 + 37


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_q,k,n_valid,layout", [
    *((_GPU_N, q, k, None, "slice") for q in (1, 19, 64, 100)
      for k in (1, 10, 64, 256)),
    (_GPU_N, 19, 64, 65_000, "contiguous"),     # rows not 16-byte aligned
    (_GPU_N, 100, 256, 40_000, "slice"),
    (2620, 8, 10, None, "contiguous"),          # the serving corpus
    (2620, 3, 256, None, "slice"),
    (300, 9, 12, 5, "contiguous"),              # masked tail, n_valid < k
    (300, 64, 256, 100, "slice"),
    (100_003, 64, 1, None, "slice"),
])
def test_fused_topk_kernel_matches_plain_on_gpu(cuda, dtype, n, n_q, k,
                                                n_valid, layout):
    """K3 against its plain version: scores within 1e-5 and ids equal
    under the tie-aware rule (the tensor cores sum in another order);
    duplicate columns across tiles and splits tie by lowest id; the
    masked tail holds masked ids in ascending order at finfo.min."""
    rng = np.random.default_rng(n + k + n_q)
    cols = _unit(rng, n, 384).T
    if layout == "slice":               # a column slice: row stride > N
        wide = np.zeros((384, n + 91), np.float32)
        wide[:, :n] = cols
        docs_t = torch.from_numpy(wide).to(cuda, dtype)[:, :n]
    else:
        docs_t = torch.from_numpy(cols.copy()).to(cuda, dtype)
    limit = n if n_valid is None else min(n, n_valid)
    dups = sorted({129, 3000, n // 2, *range(n - 40, n - 1)} & set(range(limit)))
    docs_t[:, dups] = docs_t[:, 7:8]
    q = torch.from_numpy(_unit(rng, n_q, 384)).to(cuda, dtype)
    q[0] = docs_t[:, 7]
    before = k3.K3.launches
    got_s, got_i = k3.fused_topk(q, docs_t, k, n_valid)
    scores = k3.fused_scores_reference(q, docs_t, n_valid)
    torch.cuda.synchronize()
    assert k3.K3.launches == before + 1
    m = min(limit, k)                   # unmasked places
    assert_topk_tie_aware(scores[:, :limit], m, got_s[:, :m], got_i[:, :m])
    lead = [7, *dups][:m] if 7 < limit else []   # query 0: duplicates lead
    assert got_i[0, :len(lead)].tolist() == lead
    assert len(set(got_s[0, :len(lead)].tolist())) <= 1
    if m < k:
        tail = torch.arange(limit, limit + k - m, device=cuda, dtype=torch.int32)
        assert bool((got_i[:, m:] == tail).all())
        assert bool((got_s[:, m:] == torch.finfo(torch.float32).min).all())


@pytest.mark.gpu
def test_fused_topk_shared_memory_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory sum is the kernel's own."""
    lib = k3.K3.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in (64, 102, 384, 1024, 1536, 4096):
            for qt in (16, 32, 64):
                for k in (1, 10, 64, 200, 256, 300, 1024):
                    cap = k3.capacity(k)
                    for stream_q in (0, 1):
                        assert lib.fused_topk_smem_bytes(
                            code, d, qt, cap, stream_q) == k3.smem_bytes(
                                dtype, d, qt, cap, bool(stream_q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n_q,k", [
    (384, 8, 300), (384, 64, 1024), (1536, 19, 10), (1536, 64, 300),
    (1536, 8, 1024), (8200, 3, 64),
])
def test_fused_topk_large_k_and_d_on_gpu(cuda, dtype, d, n_q, k):
    """k past 256 (buffers in shared memory up to 480, in device memory
    above) and D past 1024 (the query tile resident while it fits, else
    streamed with the docs) against the plain version, under the
    tie-aware rule with duplicate columns first. Tolerance 1e-5 per 384
    dims: the plain version's in-order fp32 sum of D rounded products
    drifts from the tensor cores' sum in proportion to D (2.1e-5 at
    D=1536 and 7.7e-5 at D=8200 were read on the card)."""
    rng = np.random.default_rng(d + k + n_q)
    n = 20_000 + 37
    docs_t = torch.from_numpy(_unit(rng, n, d).T.copy()).to(cuda, dtype)
    dups = [129, 3000, n // 2]
    docs_t[:, dups] = docs_t[:, 7:8]
    q = torch.from_numpy(_unit(rng, n_q, d)).to(cuda, dtype)
    q[0] = docs_t[:, 7]
    plan = k3.launch_plan(dtype, d, k, n, n_q, k3.sm_count(0))
    assert plan.stream_q == (d == 8200)
    before = k3.K3.launches
    got_s, got_i = k3.fused_topk(q, docs_t, k)
    scores = k3.fused_scores_reference(q, docs_t)
    torch.cuda.synchronize()
    assert k3.K3.launches == before + 1
    assert_topk_tie_aware(scores, k, got_s, got_i, tol=TOL * max(1, d / 384))
    assert got_i[0, :4].tolist() == [7, *dups]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,seg_rows", [(1536, 8), (1536, 64), (384, 64),
                                        (4000, 16)])
def test_segmax_cm_wide_and_seg_rows_64_on_gpu(cuda, dtype, d, seg_rows):
    """K4 past D=1024 (the query tile resident while it fits, else
    streamed with the docs) and at seg_rows 64, against the plain
    version."""
    rng = np.random.default_rng(d + seg_rows)
    n = 20_000 + 37
    docs_t = torch.from_numpy(_unit(rng, n, d).T.copy()).to(cuda, dtype)
    before = k4.K4.launches
    for n_q in (8, 19):
        q = torch.from_numpy(_unit(rng, n_q, d)).to(cuda, dtype)
        for n_valid in (n, n - 3001):
            got = k4.segmax_cm(q, docs_t, n_valid, seg_rows)
            ref = k4.segmax_cm_reference(q, docs_t, n_valid, seg_rows)
            torch.cuda.synchronize()
            assert got.shape == ref.shape == (n_q, k4.n_segments(n, seg_rows))
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert k4.K4.launches == before + 4


_K4_QS = (1, 7, 8, 9, 31, 33, 64, 65, 128)


def _k4_inputs(d, n, n_q, dtype, seed, cols=None):
    """Unit doc columns ``[d, cols or n]`` and queries ``[n_q, d]`` on the
    card, made from ``seed``; columns 5000-5039 copy column 3."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    docs = torch.randn(d, cols or n, generator=g, device="cuda")
    docs /= docs.norm(dim=0, keepdim=True).clamp_min(1e-12)
    docs[:, 5000:5040] = docs[:, 3:4]
    q = torch.randn(n_q, d, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return docs.to(dtype), q.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seg_rows", k4.SUPPORTED_SEG_ROWS)
@pytest.mark.parametrize("d", [1, 100, 384, 1536, 4000])
def test_segmax_cm_every_tile_and_plan_boundary_on_gpu(cuda, dtype, seg_rows, d):
    """K4 against the plain version at every query-tile boundary (Q
    1-128: one tile of 8-64, two of 64), every seg_rows, D from 1 to
    4,000 (queries resident, and streamed with the docs), N not a
    multiple of 128 and n_valid at N, in the middle of a group and of a
    128-column tile, and inside the first group (the later groups are
    wholly masked); each call launches the kernel once. At this N the
    groups are too few to fill the card, so most shapes split each
    group's members among blocks (an atomic max joins them); seg_rows 1
    keeps whole groups."""
    n = 20_000 + 37
    group = seg_rows * 128
    mid = min(n - 1, group + (seg_rows // 2) * 128 + 61)
    docs_t, qs = _k4_inputs(d, n, max(_K4_QS), dtype, seed=d + seg_rows)
    for n_q in _K4_QS:
        q = qs[:n_q].contiguous()
        for n_valid in (n, mid, 61):
            before = k4.K4.launches
            got = k4.segmax_cm(q, docs_t, n_valid, seg_rows)
            ref = k4.segmax_cm_reference(q, docs_t, n_valid, seg_rows)
            torch.cuda.synchronize()
            assert k4.K4.launches == before + 1
            assert got.shape == ref.shape == (n_q, k4.n_segments(n, seg_rows))
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 384])
def test_segmax_cm_slice_and_unaligned_on_gpu(cuda, dtype, d):
    """A column slice three columns into a matrix of odd row stride (the
    docs not 16-byte aligned: loaded element by element) and queries
    one element into their storage."""
    n = 20_000 + 37
    wide, qs = _k4_inputs(d, n, 66, dtype, seed=d, cols=n + 90)
    docs_t = wide[:, 3:3 + n]
    assert docs_t.stride(0) % 2 == 1 and docs_t.data_ptr() % 16 != 0
    for n_q in (8, 33, 65):
        flat = torch.empty(n_q * d + 1, dtype=dtype, device=cuda)
        q = flat[1:].view(n_q, d)
        q.copy_(qs[:n_q])
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
        for seg_rows in (1, 8, 64):
            for n_valid in (n, n - 3001):
                got = k4.segmax_cm(q, docs_t, n_valid, seg_rows)
                ref = k4.segmax_cm_reference(q, docs_t, n_valid, seg_rows)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q", [8, 64])
def test_twophase_duplicate_columns_tie_by_lowest_id_on_gpu(cuda, dtype, n_q):
    """Identical doc columns score identically in K4's map, so
    dense_topk_twophase on the card ranks a query's duplicates first, by
    lowest id, as its plain path does."""
    n = 20_000 + 37
    docs_t, q = _k4_inputs(384, n, n_q, dtype, seed=n_q)
    dups = [129, 3000, 9999, n - 2]
    docs_t[:, dups] = docs_t[:, 7:8]
    q[0] = docs_t[:, 7]
    before = k4.K4.launches
    _, ids = dense_topk_twophase(q, docs_t, 10, n_valid=n - 1)
    torch.cuda.synchronize()
    assert k4.K4.launches == before + 1
    assert ids[0, :4].tolist() == [7, 129, 3000, 9999]
    _, ref = dense_topk_twophase(q.cpu(), docs_t.cpu(), 10, n_valid=n - 1)
    assert ref[0, :4].tolist() == [7, 129, 3000, 9999]


@pytest.mark.gpu
def test_segmax_cm_shared_memory_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory sum is the kernel's own."""
    lib = k4.K4.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in (1, 100, 384, 1536, 4000, 8192):
            for qt in k4.QUERY_TILES:
                for stream_q in (0, 1):
                    assert lib.segmax_cm_smem_bytes(
                        code, d, qt, stream_q) == k4.smem_bytes(
                            dtype.itemsize, d, qt, bool(stream_q))
