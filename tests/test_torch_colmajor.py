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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_q,k,n_valid", [
    (2620, 8, 10, None), (2620, 3, 256, None), (65_536, 19, 64, 65_000),
    (300, 9, 12, 5), (100_003, 64, 1, None),
])
def test_fused_topk_kernel_matches_plain_on_gpu(cuda, dtype, n, n_q, k,
                                                n_valid):
    rng = np.random.default_rng(n + k)
    docs_t = torch.from_numpy(_unit(rng, n, 384).T.copy()).to(cuda, dtype)
    docs_t[:, n // 2:n // 2 + 40] = docs_t[:, 7:8]   # ties across splits
    q = torch.from_numpy(_unit(rng, n_q, 384)).to(cuda, dtype)
    q[0] = docs_t[:, 7]
    before = k3.K3.launches
    got_s, got_i = k3.fused_topk(q, docs_t, k, n_valid)
    ref_s, ref_i = k3.fused_topk_reference(q, docs_t, k, n_valid)
    torch.cuda.synchronize()
    assert k3.K3.launches == before + 1
    assert torch.equal(got_i, ref_i)
    assert torch.equal(got_s, ref_s)
