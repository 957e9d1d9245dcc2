"""Dense top-k: the port's plain two-phase path (K1's plain version on
the CPU) and its matmul path against the JAX package's
``dense_topk_twophase_rm(interpret=True)`` and ``dense_topk_xla``, for
fp32 and bf16 docs, ``n_valid`` padding, duplicate rows and ties.

Tolerance 1e-5 on scores (the tie band of tests/test_dense.py): both
sides accumulate fp32 products of the same values in another order.
Ids are compared exactly where no two scores lie within that band.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from legal_rag_tpu.ops.dense import (
    dense_topk_twophase_rm as jax_twophase, dense_topk_xla,
)
from legal_rag_tpu_torch.ops import segmax_rm as k1
from legal_rag_tpu_torch.ops.dense import (
    dense_topk_matmul, dense_topk_twophase_rm, l2_normalize,
)

TOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16(x):
    """Round to bfloat16 the way both packages do (nearest even)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def assert_topk_equiv(queries, docs, k, got_s, got_i, n_valid=None):
    """Tie-aware exact top-k against a float64 brute force (the rule of
    tests/test_dense.py): values match, order is monotone, every id
    above the tie band is present, nothing below it is."""
    n_valid = docs.shape[0] if n_valid is None else n_valid
    s64 = queries.astype(np.float64) @ docs[:n_valid].T.astype(np.float64)
    for qi in range(queries.shape[0]):
        srt = np.sort(s64[qi])[::-1]
        kth = srt[k - 1]
        np.testing.assert_allclose(got_s[qi], srt[:k], rtol=TOL, atol=TOL)
        assert (np.diff(got_s[qi]) <= TOL).all()
        assert (got_i[qi] < n_valid).all()
        got_true = s64[qi, got_i[qi]]
        np.testing.assert_allclose(got_s[qi], got_true, rtol=TOL, atol=TOL)
        assert set(np.where(s64[qi] > kth + TOL)[0]) <= set(got_i[qi])
        assert (got_true >= kth - TOL).all()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    docs = _unit(rng, 3000, 64)
    docs[1500:1510] = docs[7]          # duplicates tie exactly with doc 7
    docs[2990:] = docs[11]             # duplicates past n_valid
    queries = _unit(rng, 5, 64)
    queries[1] = docs[7]               # a query whose best hits all tie
    return queries, docs


@pytest.mark.parametrize("n_valid", [None, 2950, 2901])
def test_twophase_fp32_matches_jax(data, n_valid):
    queries, docs = data
    k = 12
    ref_s, ref_i = jax_twophase(
        jnp.asarray(queries), jnp.asarray(docs), k, block_n=1024,
        block_q=8, n_valid=n_valid, interpret=True,
    )
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries), torch.from_numpy(docs), k, n_valid=n_valid,
    )
    got_s, got_i = got_s.numpy(), got_i.numpy()
    assert_topk_equiv(queries, docs, k, got_s, got_i, n_valid)
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    np.testing.assert_allclose(got_s, np.asarray(ref_s), atol=TOL, rtol=0)
    # the tied duplicates of doc 7 come back in ascending id order
    assert list(got_i[1][:11]) == [7] + list(range(1500, 1510))


def test_twophase_bf16_matches_jax(data):
    queries, docs = data
    k = 10
    qb, db = _bf16(queries), _bf16(docs)
    ref_s, ref_i = jax_twophase(
        jnp.asarray(queries, jnp.bfloat16), jnp.asarray(docs, jnp.bfloat16),
        k, block_n=1024, block_q=8, n_valid=2950, interpret=True,
    )
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries).bfloat16(), torch.from_numpy(docs).bfloat16(),
        k, n_valid=2950,
    )
    assert_topk_equiv(qb, db, k, got_s.numpy(), got_i.numpy(), 2950)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=TOL)


def test_twophase_misaligned_rows_pad(data):
    """N not a multiple of the segment: the port pads with zero rows
    that never compete (n_valid defaults to N)."""
    queries, docs = data
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries), torch.from_numpy(docs[:2995]), 7)
    assert_topk_equiv(queries, docs[:2995], 7, got_s.numpy(), got_i.numpy())


def test_matmul_path_matches_xla_with_ties(data):
    queries, docs = data
    ref_s, ref_i = dense_topk_xla(jnp.asarray(queries), jnp.asarray(docs), 15)
    got_s, got_i = dense_topk_matmul(
        torch.from_numpy(queries), torch.from_numpy(docs), 15)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=TOL)


def test_segmax_reference_is_masked_segment_max():
    rng = np.random.default_rng(22)
    docs = _unit(rng, 64, 32)
    q = _unit(rng, 3, 32)
    out = k1.segmax_rm_reference(torch.from_numpy(q), torch.from_numpy(docs), 37)
    s = q @ docs.T
    s[:, 37:] = np.finfo(np.float32).min
    np.testing.assert_allclose(out.numpy(), s.reshape(3, 8, 8).max(axis=2),
                               atol=1e-6)
    assert out.shape == (3, 8) and out.dtype == torch.float32


def test_segmax_cpu_tensors_take_the_plain_version_uncounted():
    before = k1.K1.launches
    k1.segmax_rm(torch.ones(2, 128), torch.ones(16, 128), 16)
    assert k1.K1.launches == before


def test_segmax_non_cpu_tensors_never_reach_the_plain_version():
    """Tensors off the CPU go to the kernel or raise; here (meta
    tensors) they raise before any launch."""
    q = torch.empty(8, 384, device="meta")
    d = torch.empty(1024, 384, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k1.segmax_rm(q, d, 1000)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seg_rows,d", [(16, 64), (32, 64), (8, 100),
                                        (8, 200), (16, 100)])
def test_twophase_seg_rows_and_widths_match_jax(dtype, seg_rows, d):
    """The shapes K1 admits beyond seg_rows 8 and the served widths:
    the port's two-phase top-k against the JAX package's at a block_n
    that divides by seg_rows * 128 (4096), scores within 1e-5 (fp32 sums
    of the same products in another order) and ids equal, with
    duplicates of doc 7 inside and across segments tied by lowest id."""
    rng = np.random.default_rng(seg_rows * 1000 + d)
    docs = _unit(rng, 3000, d)
    docs[1500:1510] = docs[7]
    queries = _unit(rng, 5, d)
    queries[1] = docs[7]
    if dtype == "bfloat16":
        queries, docs = _bf16(queries), _bf16(docs)
    ref_s, ref_i = jax_twophase(
        jnp.asarray(queries, dtype), jnp.asarray(docs, dtype), 12,
        block_n=4096, block_q=8, seg_rows=seg_rows, n_valid=2950,
        interpret=True,
    )
    tdt = getattr(torch, dtype)
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries).to(tdt), torch.from_numpy(docs).to(tdt), 12,
        n_valid=2950, seg_rows=seg_rows,
    )
    assert_topk_equiv(queries, docs, 12, got_s.numpy(), got_i.numpy(), 2950)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=TOL)
    assert list(got_i[1][:11]) == [7] + list(range(1500, 1510))


def _quantize_segments(docs, seg_rows):
    """int8 codes with one symmetric scale per seg_rows rows (the scale
    commutes with the segment max): ``(codes [N, D], scales [N])``."""
    seg = docs.reshape(-1, seg_rows, docs.shape[1])
    scale = np.abs(seg).max(axis=(1, 2)) / 127.0
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    codes = np.clip(np.round(seg / scale[:, None, None]), -127, 127)
    return (codes.astype(np.int8).reshape(docs.shape),
            np.repeat(scale, seg_rows))


@pytest.mark.parametrize("n_valid", [None, 2901])
def test_int8_twophase_seg_rows_16_matches_jax(n_valid):
    """int8 docs with one scale per 16-row segment at seg_rows 16: the
    int32 map is exact on both sides, so ids are equal and scores agree
    within 1e-5 (the same dequantization products)."""
    rng = np.random.default_rng(16)
    docs = _unit(rng, 3008, 64)
    docs[1504:1520] = docs[0:16]          # a whole segment repeated
    queries = _unit(rng, 5, 64)
    queries[1] = docs[5]
    codes, scales = _quantize_segments(docs, 16)
    ref_s, ref_i = jax_twophase(
        jnp.asarray(queries), jnp.asarray(codes), 12, block_n=2048,
        block_q=8, seg_rows=16, n_valid=n_valid, interpret=True,
        doc_scales=jnp.asarray(scales),
    )
    got_s, got_i = dense_topk_twophase_rm(
        torch.from_numpy(queries), torch.from_numpy(codes), 12,
        n_valid=n_valid, seg_rows=16, doc_scales=torch.from_numpy(scales),
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=TOL,
                               rtol=0)
    assert got_i[1, :2].tolist() == [5, 1509]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_segmax_launch_plan_fits_every_shape(dtype):
    """For every width up to 4,096 (and a few far beyond) and Q in
    1..128: the smallest built query tile that holds Q, or tiles of 64
    (ceil(Q / 64) of them) above 64, and a block's shared memory within
    the card's 232,448 bytes, the queries resident wherever they fit,
    unless streaming them lets two blocks share an SM at 64 queries."""
    elt = torch.empty((), dtype=dtype).element_size()
    plan = k1.launch_plan.__wrapped__
    assert k1.QUERY_TILES == (8, 16, 32, 64)
    for d in [*range(1, 4097), 10_000, 66_000]:
        for n_q in range(1, 129):
            p = plan(dtype, d, n_q)
            assert p.query_tile == min(t for t in k1.QUERY_TILES
                                       if t >= min(n_q, 64))
            assert -(-n_q // p.query_tile) == -(-n_q // 64)
            assert p.smem == k1.smem_bytes(elt, d, p.query_tile, p.stream_q)
            assert p.smem <= k1.MAX_SMEM == 232_448
            resident = k1.smem_bytes(elt, d, p.query_tile, False)
            streamed = k1.smem_bytes(elt, d, p.query_tile, True)
            two = k1.TWO_BLOCKS_SMEM
            assert p.stream_q == (resident > k1.MAX_SMEM or (
                p.query_tile == 64 and resident > two and streamed <= two))


def test_segmax_dispatch_and_int8_width_limit():
    """The CUDA-core kernel keeps the small fp32 and int8 batches at its
    shapes; bf16, any other seg_rows, width or batch takes the tensor
    cores. INT8_MAX_DIM, past which the int8 wrapper raises, is the
    widest D whose most negative dot product (D * -128 * 127, above
    -D * 128**2) stays above the -2**30 mask."""
    assert set(k1.CUDA_CORE_MAX_Q) == {torch.float32, torch.int8}
    for dtype, small in k1.CUDA_CORE_MAX_Q.items():
        assert not k1.uses_tensor_cores(dtype, 384, small, 8)
        assert k1.uses_tensor_cores(dtype, 384, small + 1, 8)
        assert k1.uses_tensor_cores(dtype, 100, 1, 8)
    assert k1.uses_tensor_cores(torch.float32, 384, 1, 16)
    for n_q in (1, 8, 64):
        assert k1.uses_tensor_cores(torch.bfloat16, 384, n_q, 8)
    assert k1.INT8_MAX_DIM * 128 ** 2 < 2 ** 30 <= (k1.INT8_MAX_DIM + 1) * 128 ** 2
    assert k1.INT8_MAX_DIM == 65_535


def test_l2_normalize_zero_row_safe():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0, 0]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_valid", [(8, 8 * 1500 - 5), (70, 8 * 1400)])
def test_segmax_kernel_matches_plain_on_gpu(cuda, dtype, n_q, n_valid):
    rng = np.random.default_rng(23)
    docs = torch.from_numpy(_unit(rng, 8 * 1500, 384)).to(cuda, dtype)
    docs[100:140] = docs[3]
    q = torch.from_numpy(_unit(rng, n_q, 384)).to(cuda, dtype)
    before = k1.K1.launches
    got = k1.segmax_rm(q, docs, n_valid)
    torch.cuda.synchronize()
    assert k1.K1.launches == before + 1
    ref = k1.segmax_rm_reference(q, docs, n_valid)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _k1_inputs(rng, n, d, n_q, dtype, device):
    """Unit-row fp32/bf16 docs and queries, or int8 values in [-127, 127];
    rows 100-139 repeat row 3."""
    if dtype == torch.int8:
        docs = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8))
        q = torch.from_numpy(rng.integers(-127, 128, (n_q, d), dtype=np.int8))
    else:
        docs = torch.from_numpy(_unit(rng, n, d)).to(dtype)
        q = torch.from_numpy(_unit(rng, n_q, d)).to(dtype)
    docs[100:140] = docs[3]
    return docs.to(device), q.to(device)


def _k1_count(dtype):
    return k1.K1.int8_launches if dtype == torch.int8 else k1.K1.launches


def _assert_k1_equal(got, ref, dtype):
    """int8: bit-equal (exact int32 sums); fp32/bf16: within 1e-5 (fp32
    sums of the same products in the tensor cores' order)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [100, 384, 1000])
@pytest.mark.parametrize("seg_rows", [1, 2, 4, 8, 16, 32, 64])
def test_segmax_kernel_every_shape_on_gpu(cuda, dtype, d, seg_rows):
    """Every seg_rows and width the reference takes, at Q from one
    request to two query tiles: each call launches a kernel and agrees
    with the plain version."""
    rng = np.random.default_rng(d * 100 + seg_rows)
    n = 64 * 170
    docs, qs = _k1_inputs(rng, n, d, 130, dtype, cuda)
    for n_q in (1, 8, 64, 67, 128, 130):
        q = qs[:n_q].contiguous()
        for n_valid in (n, n - 77):
            before = _k1_count(dtype)
            got = k1.segmax_rm(q, docs, n_valid, seg_rows)
            torch.cuda.synchronize()
            assert _k1_count(dtype) == before + 1
            _assert_k1_equal(got, k1.segmax_rm_reference(q, docs, n_valid,
                                                         seg_rows), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,offset", [(33, 1), (100, 1), (384, 3), (2048, 0)])
def test_segmax_tensor_cores_unaligned_and_streamed_on_gpu(cuda, dtype, d,
                                                           offset):
    """Rows that start off 16 bytes (a view one or three rows into its
    storage, odd widths: narrower copies or byte loads) and a query tile
    too wide to stay resident (D=2048: 64-query tiles stream)."""
    rng = np.random.default_rng(d + offset)
    n = 8 * 600
    docs, qs = _k1_inputs(rng, n + offset, d, 80 + offset, dtype, cuda)
    docs, q = docs[offset:], qs[offset:]
    stream_q = k1.launch_plan(dtype, d, 80).stream_q
    assert stream_q if d == 2048 else (d != 33 or not stream_q)
    before = k1.K1.tensor_core_launches
    for seg_rows in (8, 64):
        got = k1._launch_tensor_cores(q, docs, n - 5, seg_rows)
        torch.cuda.synchronize()
        _assert_k1_equal(got, k1.segmax_rm_reference(q, docs, n - 5, seg_rows),
                         dtype)
    assert k1.K1.tensor_core_launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n_q", [1, 8, 32])
def test_segmax_both_kernels_agree_on_gpu(cuda, dtype, n_q):
    """At the CUDA-core kernel's shapes both kernels give the plain
    version's map; the dispatch takes the one uses_tensor_cores names."""
    rng = np.random.default_rng(n_q)
    docs, q = _k1_inputs(rng, 8 * 2000, 384, n_q, dtype, cuda)
    ref = k1.segmax_rm_reference(q, docs, 8 * 2000 - 3)
    for tc in (False, True):
        before = k1.K1.tensor_core_launches
        got = (k1._launch_tensor_cores(q, docs, 8 * 2000 - 3, 8) if tc
               else k1._launch_cuda_cores(q, docs, 8 * 2000 - 3))
        torch.cuda.synchronize()
        assert k1.K1.tensor_core_launches == before + int(tc)
        _assert_k1_equal(got, ref, dtype)
    before = k1.K1.tensor_core_launches
    k1.segmax_rm(q, docs, 8 * 2000)
    assert k1.K1.tensor_core_launches - before == int(
        k1.uses_tensor_cores(dtype, 384, n_q, 8))


@pytest.mark.gpu
def test_segmax_shared_memory_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory sum is the kernel's own."""
    lib = k1.K1.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1), (torch.int8, 2)):
        elt = torch.empty((), dtype=dtype).element_size()
        for d in (1, 100, 384, 1000, 4096):
            for qt in k1.QUERY_TILES:
                for stream_q in (0, 1):
                    assert lib.segmax_rm_tc_smem_bytes(code, d, qt, stream_q) \
                        == k1.smem_bytes(elt, d, qt, bool(stream_q))
