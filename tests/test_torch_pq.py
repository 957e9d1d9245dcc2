"""The PQ + IVF capacity tier of the port against the JAX package:
training (k-means, OPQ), coding, the PQ top-k around kernel K2 (its
plain version here; the JAX side's Pallas kernel in interpret mode),
IVF building and probing, the store's IVF artifacts, and the PQ engine
over a store built by the JAX package's ``build --pq-m --ivf-cell-size``.

Tolerances: codebooks and rotations 1e-4 (fp32 k-means sums in another
order); PQ scores 1e-5 (fp32 sums of 2m decoded subspace products in
another order); IVF cell means 1e-6; codes, cell layouts and ids exact,
with ids that tie within the score tolerance free to trade places.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legal_rag_tpu.ops.pq as jpq
from legal_rag_tpu.config import (
    DenseConfig, EncoderConfig, RetrievalConfig, ShardingConfig,
)
from legal_rag_tpu.parallel.mesh import make_mesh
from legal_rag_tpu_torch.ops import pq as tpq
from legal_rag_tpu_torch.ops import pq_segmax as k2

D, M = 64, 8
TOL = 1e-5
# the reference's pallas_call takes the powers of two at its block sizes;
# on the card the kernels also run the others (a sample of them)
POW2_SEG_ROWS = (1, 2, 4, 8, 16, 32, 64)
GPU_SEG_ROWS = POW2_SEG_ROWS + (3, 5, 12, 24, 33, 63)


@pytest.fixture(scope="module")
def clustered():
    """tests/test_pq.py's corpus with real cluster structure."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((50, D)).astype(np.float32)
    assign = rng.integers(0, 50, 2000)
    docs = centers[assign] + 0.15 * rng.standard_normal((2000, D))
    docs = docs.astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = centers[rng.integers(0, 50, 16)] + 0.2 * rng.standard_normal((16, D))
    q = q.astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return docs, q


@pytest.fixture(scope="module")
def jax_cb(clustered):
    """Codebooks with an OPQ rotation, trained by the JAX package."""
    return jpq.train_pq(clustered[0], m=M, iters=15, seed=0, opq_iters=4)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_under_ties(got_s, got_i, ref_s, ref_i, tol=TOL):
    """Finite scores equal within ``tol`` rank by rank; where ids differ,
    the reference holds the port's id at a rank whose score ties (within
    ``tol``), or the two sides split a tie at the list's end."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    ref_s, ref_i = np.asarray(ref_s), np.asarray(ref_i)
    assert got_s.shape == ref_s.shape
    for r in range(ref_s.shape[0]):
        fin = np.isfinite(ref_s[r])
        np.testing.assert_array_equal(np.isfinite(got_s[r]), fin)
        np.testing.assert_allclose(got_s[r][fin], ref_s[r][fin], atol=tol,
                                   rtol=0)
        for j in np.where((got_i[r] != ref_i[r]) & fin)[0]:
            at = np.where(ref_i[r] == got_i[r, j])[0]
            if len(at):
                assert abs(ref_s[r, at[0]] - ref_s[r, j]) <= tol, (r, j)
            else:
                assert ref_s[r, j] <= ref_s[r][fin][-1] + tol, (r, j)


# -- training and coding -------------------------------------------------


@pytest.mark.parametrize("opq_iters", [0, 4])
def test_train_pq_matches_jax(clustered, opq_iters):
    docs, _ = clustered
    ref = jpq.train_pq(docs, m=M, iters=15, seed=0, opq_iters=opq_iters)
    got = tpq.train_pq(docs, m=M, iters=15, seed=0, opq_iters=opq_iters,
                        device="cpu")
    assert got.codebooks.shape == (2 * M, 16, D // (2 * M))
    np.testing.assert_allclose(got.codebooks, ref.codebooks, atol=1e-4,
                               rtol=0)
    if opq_iters:
        np.testing.assert_allclose(got.rotation, ref.rotation, atol=1e-4,
                                   rtol=0)
    else:
        assert got.rotation is None and ref.rotation is None


def test_train_pq_samples_rows_as_jax_does(clustered):
    """A sample smaller than N: the same rows are drawn."""
    docs, _ = clustered
    ref = jpq.train_pq(docs, m=M, iters=6, sample=500, seed=3)
    got = tpq.train_pq(docs, m=M, iters=6, sample=500, seed=3,
                        device="cpu")
    np.testing.assert_allclose(got.codebooks, ref.codebooks, atol=1e-4)


def test_encode_pq_matches_jax(clustered, jax_cb):
    """Codes from JAX-trained codebooks. A nibble may differ only where
    its two best logits lie within 1e-5 (fp32 rounding decides); such
    nibbles are found in float64, excluded and counted."""
    docs, _ = clustered
    ref = jpq.unpack_codes(jpq.encode_pq(docs, jax_cb))
    got = tpq.unpack_codes(tpq.encode_pq(docs, tpq.PQCodebook(*jax_cb),
                                       device="cpu"))
    x = (docs.astype(np.float64) @ jax_cb.rotation).reshape(len(docs), 2 * M, -1)
    c = jax_cb.codebooks.astype(np.float64)
    logits = np.einsum("bmd,mcd->bmc", x, c) - 0.5 * (c * c).sum(2)[None]
    top2 = np.sort(logits, axis=2)[:, :, -2:]
    near_tie = (top2[:, :, 1] - top2[:, :, 0]) < 1e-5
    differ = got != ref
    assert not (differ & ~near_tie).any()
    assert differ.sum() <= near_tie.sum() <= 0.001 * near_tie.size


def test_decode_and_unpack_are_the_jax_functions(clustered, jax_cb):
    docs, _ = clustered
    codes = jpq.encode_pq(docs[:50], jax_cb)
    np.testing.assert_array_equal(tpq.unpack_codes(codes),
                                  jpq.unpack_codes(codes))
    np.testing.assert_array_equal(tpq.decode_pq(codes, tpq.PQCodebook(*jax_cb)),
                                  jpq.decode_pq(codes, jax_cb))


# -- K2 and the PQ top-k -------------------------------------------------


def test_pq_segmax_reference_is_the_masked_lut_sum(clustered, jax_cb):
    docs, q = clustered
    codes = jpq.encode_pq(docs[:77], jax_cb)
    lut = tpq.pq_lut(torch.from_numpy(jax_cb.rotate(q[:3])),
                     torch.from_numpy(jax_cb.codebooks)).to(torch.bfloat16)
    got = k2.pq_segmax_reference(lut, torch.from_numpy(codes))
    nibs = jpq.unpack_codes(codes)
    lf = lut.float().numpy()
    s = np.zeros((3, 80))
    s[:, 77:] = np.finfo(np.float32).min
    for sub in range(2 * M):
        s[:, :77] += lf[:, sub, nibs[:, sub]]
    assert got.shape == (3, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), s.reshape(3, 10, 8).max(axis=2),
                               rtol=1e-6)


def test_pq_segmax_cpu_tensors_take_the_plain_version_uncounted():
    before = k2.K2.launches
    k2.pq_segmax(torch.zeros(2, 16, 16, dtype=torch.bfloat16),
                 torch.zeros(9, 8, dtype=torch.uint8))
    assert k2.K2.launches == before


def test_pq_segmax_non_cpu_tensors_never_reach_the_plain_version():
    lut = torch.empty(8, 96, 16, dtype=torch.bfloat16, device="meta")
    codes = torch.empty(1000, 48, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k2.pq_segmax(lut, codes)


@pytest.mark.parametrize("n,n_valid,k", [
    (2000, None, 10), (2000, 1700, 10), (2000, 1701, 25), (777, None, 20),
])
def test_pq_topk_matches_jax(clustered, jax_cb, n, n_valid, k):
    docs, q = clustered
    codes = jpq.encode_pq(docs[:n], jax_cb)
    qr = jax_cb.rotate(q)
    ref_s, ref_i = jpq.pq_topk(
        jnp.asarray(qr), jnp.asarray(codes), jnp.asarray(jax_cb.codebooks),
        k, n_valid=None if n_valid is None else jnp.int32(n_valid),
        block_n=512, interpret=True,
    )
    got_s, got_i = tpq.pq_topk(
        torch.from_numpy(qr), torch.from_numpy(codes),
        torch.from_numpy(jax_cb.codebooks), k, n_valid=n_valid,
    )
    assert got_i.dtype == torch.int32 and got_s.shape == (16, k)
    limit = n if n_valid is None else n_valid
    fin = torch.isfinite(got_s)
    assert bool((got_i[fin] < limit).all())
    assert_same_under_ties(got_s, got_i, ref_s, ref_i)


@pytest.mark.parametrize("m", [24, 96])
def test_pq_topk_wide_codes_match_jax(m):
    """Code widths K2 admits beyond 8-48 (D=384: 8 and 2 dims a nibble
    subspace), on 1,500 docs coded by the JAX package with seeded
    codebooks: the port's pq_topk against the JAX pq_topk in interpret
    mode, scores within 1e-5 (fp32 sums of 2m bf16 entries in another
    order), ids under the tie rule, the duplicates of doc 7 first."""
    rng = np.random.default_rng(m)
    d = 384
    cb = jpq.PQCodebook(
        codebooks=(rng.standard_normal((2 * m, 16, d // (2 * m))) * 0.1
                   ).astype(np.float32),
        rotation=None)
    docs = _unit_rows(rng, 1500, d)
    docs[900:905] = docs[7]
    codes = jpq.encode_pq(docs, cb)
    assert codes.shape == (1500, m)
    q = _unit_rows(rng, 9, d)
    q[0] = jpq.decode_pq(codes[7:8], cb)[0]
    ref_s, ref_i = jpq.pq_topk(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb.codebooks), 20,
        n_valid=jnp.int32(1490), block_n=512, interpret=True,
    )
    got_s, got_i = tpq.pq_topk(
        torch.from_numpy(q), torch.from_numpy(codes),
        torch.from_numpy(cb.codebooks), 20, n_valid=1490,
    )
    assert got_s.shape == (9, 20) and bool((got_i < 1490).all())
    assert_same_under_ties(got_s, got_i, ref_s, ref_i)
    assert got_i[0, :6].tolist() == [7, 900, 901, 902, 903, 904]


def _jax_segmax(lut, codes, seg_rows):
    """The JAX package's K2 (``_pq_segmax_kernel``) alone, in interpret
    mode, laid out as ``jpq.pq_topk`` launches it: ``[Q, n_pad / sr]``
    over the block-padded codes."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    n, m = codes.shape
    q = lut.shape[0]
    block_n = -(-n // (seg_rows * 128)) * seg_rows * 128
    codes = np.pad(codes, ((0, block_n - n), (0, 0)))
    spread = ((np.arange(128)[None, :] >> 5) == np.arange(4)[:, None])
    lut_k = jnp.asarray(np.transpose(lut, (1, 2, 0))).astype(
        jnp.bfloat16).reshape(m // 4, 128, q)
    kernel = functools.partial(jpq._pq_segmax_kernel, seg_rows=seg_rows,
                               block_n=block_n, n_real=n, m=m)
    return np.asarray(pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec((block_n, m), lambda j: (0, 0)),
                  pl.BlockSpec((m // 4, 128, q), lambda j: (0, 0, 0)),
                  pl.BlockSpec((4, 128), lambda j: (0, 0))],
        out_specs=pl.BlockSpec((q, block_n // seg_rows), lambda j: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, block_n // seg_rows), jnp.float32),
        interpret=True,
    )(jnp.asarray(codes), lut_k, jnp.asarray(spread, jnp.float32)))


@pytest.mark.parametrize("seg_rows", POW2_SEG_ROWS)
def test_pq_segmax_reference_matches_the_jax_kernel_at_every_seg_rows(
        clustered, jax_cb, seg_rows):
    """The plain K2 against the JAX package's Pallas kernel (interpret
    mode) on the same bf16 tables, 1,001 docs (the last segment part
    full): segment maxima within 1e-5 (fp32 sums of 2m bf16 entries in
    another order)."""
    docs, q = clustered
    codes = jpq.encode_pq(docs[:1001], jax_cb)
    lut = tpq.pq_lut(torch.from_numpy(jax_cb.rotate(q[:5])),
                     torch.from_numpy(jax_cb.codebooks)).to(torch.bfloat16)
    got = k2.pq_segmax_reference(lut, torch.from_numpy(codes), seg_rows)
    n_segs = -(-1001 // seg_rows)
    assert got.shape == (5, n_segs)
    ref = _jax_segmax(lut.float().numpy(), codes, seg_rows)[:, :n_segs]
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("seg_rows", POW2_SEG_ROWS)
def test_pq_topk_matches_jax_at_every_seg_rows(clustered, jax_cb, seg_rows):
    """``pq_topk(..., seg_rows=)`` for each segment the kernels take
    against the JAX pq_topk in interpret mode, with n_valid inside a
    segment: scores within 1e-5, ids under the tie rule."""
    docs, q = clustered
    n, n_valid, k = 1800, 1757, 10
    codes = jpq.encode_pq(docs[:n], jax_cb)
    qr = jax_cb.rotate(q)
    ref_s, ref_i = jpq.pq_topk(
        jnp.asarray(qr), jnp.asarray(codes), jnp.asarray(jax_cb.codebooks),
        k, n_valid=jnp.int32(n_valid), block_n=512, seg_rows=seg_rows,
        interpret=True,
    )
    got_s, got_i = tpq.pq_topk(
        torch.from_numpy(qr), torch.from_numpy(codes),
        torch.from_numpy(jax_cb.codebooks), k, n_valid=n_valid,
        seg_rows=seg_rows,
    )
    assert bool((got_i < n_valid).all())
    assert_same_under_ties(got_s, got_i, ref_s, ref_i)


@pytest.mark.parametrize("seg_rows", [3, 12])
def test_pq_topk_at_seg_rows_the_kernels_do_not_take(clustered, jax_cb,
                                                      seg_rows):
    """The reference runs a seg_rows that is not a power of two where
    its block is a multiple of ``seg_rows * 128`` (more docs than one
    block of 4,096); the port's plain version takes it too, and so do
    the kernels on the card (test_pq_topk_at_odd_seg_rows_on_gpu)."""
    docs, q = clustered
    codes = jpq.encode_pq(np.tile(docs, (3, 1))[:5000], jax_cb)
    qr = jax_cb.rotate(q[:4])
    ref_s, ref_i = jpq.pq_topk(
        jnp.asarray(qr), jnp.asarray(codes), jnp.asarray(jax_cb.codebooks),
        10, seg_rows=seg_rows, interpret=True,
    )
    got_s, got_i = tpq.pq_topk(
        torch.from_numpy(qr), torch.from_numpy(codes),
        torch.from_numpy(jax_cb.codebooks), 10, seg_rows=seg_rows,
    )
    assert_same_under_ties(got_s, got_i, ref_s, ref_i)


def test_pq_segmax_launch_plan_fits_every_width():
    """Every m % 4 == 0 up to TC_MAX_M (and Q up to 128) plans a built
    query tile that holds Q where it fits, and a block within 232,448
    bytes of shared memory; wider codes raise there and take the lookup
    kernel, whose tile holds at least one query's tables."""
    for m, n_q in ((m, n_q) for m in range(4, 400, 4) for n_q in range(1, 129)):
        if m > k2.TC_MAX_M:
            assert k2.lookup_tile(m, n_q) >= 1 and m <= k2.MAX_M
            with pytest.raises(ValueError, match="fit"):
                k2.launch_plan.__wrapped__(m, n_q)
            continue
        p = k2.launch_plan.__wrapped__(m, n_q)
        assert p.query_tile in k2.QUERY_TILES and p.stages in (1, 2)
        assert p.smem == k2.smem_bytes(m, p.query_tile, p.stages)
        assert p.smem <= k2.MAX_SMEM == 232_448
        want = min(t for t in k2.QUERY_TILES if t >= min(n_q, 64))
        fits = [t for t in k2.QUERY_TILES
                if t <= want and k2.smem_bytes(m, t, 1) <= k2.MAX_SMEM]
        assert p.query_tile == max(fits)


def test_pq_search_rescored_matches_jax(clustered, jax_cb):
    docs, q = clustered
    codes = jpq.encode_pq(docs, jax_cb)
    ref_s, ref_i = jpq.pq_search_rescored(
        q, jnp.asarray(codes), jax_cb, docs, k=10, oversample=8,
        interpret=True,
    )
    got_s, got_i = tpq.pq_search_rescored(
        q, torch.from_numpy(codes), tpq.PQCodebook(*jax_cb), docs, k=10,
        oversample=8,
    )
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_allclose(got_s, ref_s, atol=TOL)


# -- IVF -----------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf(clustered, jax_cb):
    docs, _ = clustered
    codes = jpq.encode_pq(docs, jax_cb)
    return codes, jpq.build_ivf(docs, jax_cb, codes, cell_size=64, iters=10,
                                seed=0)


def test_build_ivf_matches_jax(clustered, jax_cb, ivf):
    docs, _ = clustered
    codes, ref = ivf
    got = tpq.build_ivf(docs, tpq.PQCodebook(*jax_cb), codes, cell_size=64,
                        iters=10, seed=0, device="cpu")
    assert got.cell_size == ref.cell_size and got.n_cells == ref.n_cells
    np.testing.assert_array_equal(got.doc_ids, ref.doc_ids)
    np.testing.assert_array_equal(got.codes, ref.codes)
    np.testing.assert_allclose(got.centroids, ref.centroids, atol=1e-6,
                               rtol=0)


def _probed_docs(ids):
    return [set(row[row >= 0].tolist()) for row in np.asarray(ids)]


@pytest.mark.parametrize("probes", [3, 16, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_pq_ivf_topk_matches_jax(clustered, jax_cb, ivf, probes, masked):
    """Partial and full probes, with and without padded queries: the
    same cells are probed (every member of them comes back at
    k = probes * cell_size), and the top-10 agree."""
    _, q = clustered
    _, index = ivf
    qr = jax_cb.rotate(q[:8])
    valid = np.arange(8) < (5 if masked else 8)
    jq_valid = jnp.asarray(valid) if masked else None
    tq_valid = torch.from_numpy(valid) if masked else None
    k_all = min(probes, index.n_cells) * index.cell_size
    for k in (k_all, 10):
        ref_s, ref_i = jpq.pq_ivf_topk(
            jnp.asarray(qr), index, jax_cb.codebooks, k, probes=probes,
            interpret=True, q_valid=jq_valid,
        )
        got_s, got_i = tpq.pq_ivf_topk(
            torch.from_numpy(qr), index, jax_cb.codebooks, k, probes=probes,
            q_valid=tq_valid,
        )
        if k == k_all:
            assert _probed_docs(got_i) == _probed_docs(ref_i)
        else:
            assert_same_under_ties(got_s[valid], got_i[valid],
                                   np.asarray(ref_s)[valid],
                                   np.asarray(ref_i)[valid])


def test_ivf_empty_pad_cells_never_probed():
    """tests/test_pq.py:633 on both packages: empty cells with a huge
    negative centroid lose to real cells even for all-negative
    queries, because cells are valid by their ids."""
    rng = np.random.default_rng(3)
    docs = rng.standard_normal((96, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    cb = jpq.train_pq(docs, m=M, iters=6, seed=0)
    codes = jpq.encode_pq(docs, cb)
    cs = 16
    index = jpq.build_ivf(docs, cb, codes, cell_size=cs, iters=6, seed=0)
    cents = np.vstack([index.centroids, np.full((2, D), -1e30, np.float32)])
    codes_p = np.vstack([index.codes, np.zeros((2 * cs, M), np.uint8)])
    ids_p = np.concatenate([index.doc_ids, np.full(2 * cs, -1, np.int32)])
    q = -np.abs(rng.standard_normal((2, D))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref_s, ref_i = jpq._pq_ivf_topk_impl(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(codes_p),
        jnp.asarray(ids_p), jnp.asarray(cb.codebooks), 5, 6, cs, True,
    )
    got_s, got_i = tpq._pq_ivf_topk_impl(
        torch.from_numpy(q), torch.from_numpy(cents),
        torch.from_numpy(codes_p), torch.from_numpy(ids_p),
        torch.from_numpy(cb.codebooks), 5, 6, cs,
    )
    assert bool((got_i >= 0).all())
    assert_same_under_ties(got_s, got_i, ref_s, ref_i)


def test_ivf_q_valid_keeps_padded_queries_out_of_the_vote():
    """tests/test_pq.py:684 on the port: with 2 probes for 4 rows, the
    2 real queries get their own cells only when the pad rows are
    masked."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((6, D)).astype(np.float32) * 4
    docs = np.concatenate([
        c + 0.05 * rng.standard_normal((16, D)).astype(np.float32)
        for c in centers
    ])
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    cb = jpq.train_pq(docs, m=M, iters=6, seed=0)
    codes = jpq.encode_pq(docs, cb)
    cents = np.stack([docs[16 * i:16 * (i + 1)].mean(0) for i in range(6)])
    ids = np.arange(96, dtype=np.int32)
    q = np.stack([docs[64], docs[80], 3.0 * docs[0], 3.0 * docs[16]])
    args = [torch.from_numpy(a) for a in (q, cents, codes, ids, cb.codebooks)]
    _, masked = tpq._pq_ivf_topk_impl(
        *args, 3, 2, 16, q_valid=torch.tensor([True, True, False, False]))
    _, flat = tpq.pq_topk(torch.from_numpy(q[:2]), torch.from_numpy(codes),
                          torch.from_numpy(cb.codebooks), 3)
    np.testing.assert_array_equal(masked[:2].numpy(), flat.numpy())
    _, unmasked = tpq._pq_ivf_topk_impl(*args, 3, 2, 16)
    assert not np.array_equal(unmasked[:2].numpy(), flat.numpy())


# -- the store and the engine --------------------------------------------

ENC = EncoderConfig(vocab_size=4000, hidden=32, layers=2, heads=4,
                    intermediate=64, max_len=64, encode_batch=64)
WORDS = ("police fir arrest bail victim robbery theft court witness "
         "magistrate custody evidence compensation warrant").split()


def _cfg(dtype="pq", **dense):
    return RetrievalConfig(
        dense=DenseConfig(dtype=dtype, pq_m=M, **dense), encoder=ENC,
        sharding=ShardingConfig(num_shards=1),
    )


@pytest.fixture(scope="module")
def pq_store_dir(tmp_path_factory):
    """400 synthetic chunks built by the JAX package with
    ``--pq-m 8 --ivf-cell-size 8`` (50 cells)."""
    from legal_rag_tpu.index.builder import build_index

    rng = np.random.default_rng(61)
    filler = [f"t{i}" for i in range(300)] + "the of and to a in".split()
    chunks = []
    for i in range(400):
        words = list(rng.choice(WORDS, size=int(rng.integers(2, 6))))
        words += list(rng.choice(filler, size=int(rng.integers(8, 30))))
        chunks.append({
            "text": " ".join(words), "canonical_header": f"SYN {i}",
            "section_id": f"SYN_{i}",
            "metadata": {"law": "SYN", "section": str(i),
                         "unit_type": "section"},
        })
    d = tmp_path_factory.mktemp("pq_store")
    build_index(chunks, config=_cfg(), store_dir=d, pq_m=M, ivf_cell_size=8)
    return d


def test_store_ivf_index_matches_jax(pq_store_dir):
    """The port's VectorStore reads a JAX-built IVF store and rebuilds
    the same IVFIndex (the cell-ordered codes derive from pq.npz)."""
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu_torch.index.store import VectorStore

    ref = JaxStore.load(pq_store_dir).ivf_index()
    got = VectorStore.load(pq_store_dir).ivf_index()
    assert type(got).__name__ == "IVFIndex" and got._fields == ref._fields
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert got.n_cells == ref.n_cells == 50 and got.n_pad == ref.n_pad


ENGINE_QUERIES = ["police fir arrest", "victim compensation court",
                  "robbery theft t5 t17", "bail magistrate custody warrant",
                  "witness evidence t100"]


@pytest.fixture
def jax_per_doc_segment_sums(monkeypatch):
    """The JAX package's BM25 segment totals taken as each doc's own sum,
    for the RRF cases over IVF ([rrf-True-33], [rrf-True-64]) alone.

    IVF always takes the segment sums. The port's are exact (64-bit
    fixed point), so docs whose postings carry the same weights tie
    exactly and ``lax_top_k`` orders them by id; the JAX package takes
    each total as a difference of one float32 running sum, whose
    rounding parts such docs in an order of its own, and RRF then moves
    their fused scores by a rank (the weighted cases are held against
    the unpatched JAX engine, where the two agree). Summing each doc's
    own postings (a scatter over the corpus, as the scatter path does)
    keeps those ties and leaves everything else of the JAX engine as it
    is."""
    import jax
    import legal_rag_tpu.parallel.sharded as jsh

    running_sum = jsh._bm25_segment_stats

    def per_doc(pids, pw, n_docs):
        sid, valid, _, _ = running_sum(pids, pw, n_docs)
        q = pids.shape[0]
        ids = jnp.where((pids >= 0) & (pids < n_docs), pids, n_docs)
        acc = jnp.zeros((q, n_docs + 1), jnp.float32).at[
            jnp.arange(q)[:, None], ids].add(pw)
        totals = jnp.take_along_axis(acc, jnp.clip(sid, 0, n_docs), axis=1)
        gmax = jnp.max(jnp.where(valid, totals, -jnp.inf), axis=1)
        return sid, valid, totals, jnp.where(jnp.isfinite(gmax), gmax, 0.0)

    jax.clear_caches()                  # programs traced with the original
    monkeypatch.setattr(jsh, "_bm25_segment_stats", per_doc)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("use_ivf,probes", [(False, 64), (True, 33),
                                            (True, 64)])
@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_pq_engine_matches_jax(pq_store_dir, use_ivf, probes, mode, request):
    from legal_rag_tpu.index.store import VectorStore as JaxStore
    from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    if use_ivf and mode == "rrf":
        # the one known divergence: see jax_per_doc_segment_sums
        request.getfixturevalue("jax_per_doc_segment_sums")
    cfg = _cfg(use_ivf=use_ivf, ivf_probes=probes, pq_oversample=4)
    ref_engine = JaxEngine(JaxStore.load(pq_store_dir), config=cfg,
                           mesh=make_mesh(1))
    engine = RetrievalEngine(VectorStore.load(pq_store_dir), config=cfg,
                             device="cpu")
    assert engine.index.docs.dtype == torch.uint8
    assert (engine.index.ivf_centroids is not None) == use_ivf
    assert engine.index.pq_rotation is not None
    want = ref_engine.search_batch(ENGINE_QUERIES, k=5, mode=mode)
    got = engine.search_batch(ENGINE_QUERIES, k=5, mode=mode)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        assert_same_under_ties([[r.score for r in a]], [[r.doc_id for r in a]],
                               [[r.score for r in b]], [[r.doc_id for r in b]])


def test_pq_engine_trains_at_load_without_artifacts(pq_store_dir, caplog):
    """dtype='pq' over a store without pq.npz: the engine trains the
    codebooks at load (with the JAX engine's warning) and serves."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store = dataclasses.replace(VectorStore.load(pq_store_dir), pq_codes=None,
                                ivf_centroids=None)
    engine = RetrievalEngine(store, config=_cfg(), device="cpu")
    assert "boot-time k-means" in caplog.text
    assert engine.index.docs.dtype == torch.uint8
    out = engine.search_batch(["police fir", "victim court"], k=3)
    assert all(0 < len(row) <= 3 for row in out)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K2 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n", [(8, 8 * 1500 - 5), (70, 8 * 1400 + 3)])
def test_pq_segmax_kernel_matches_plain_on_gpu(cuda, n_q, n):
    rng = np.random.default_rng(39)
    codes = torch.from_numpy(
        rng.integers(0, 256, (n, 48), dtype=np.uint8)).to(cuda)
    codes[100:140] = codes[3]
    lut = torch.from_numpy(
        rng.standard_normal((n_q, 96, 16)).astype(np.float32) * 0.05
    ).to(cuda, torch.bfloat16)
    before = k2.K2.launches
    got = k2.pq_segmax(lut, codes)
    torch.cuda.synchronize()
    assert k2.K2.launches == before + 1
    ref = k2.pq_segmax_reference(lut, codes)
    assert got.shape == ref.shape == (n_q, -(-n // 8))
    torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 12, 24, 48, 96, 192, 256, 384])
@pytest.mark.parametrize("n_q,n", [(8, 8 * 700 - 5), (67, 8 * 640 + 3),
                                   (128, 8 * 300 + 5)])
def test_pq_segmax_every_width_on_gpu(cuda, m, n_q, n):
    """Every m % 4 == 0 the reference serves at D=384 and 768: the query
    tile shrinks as the tables grow (launch_plan); the dispatch (the
    tensor cores up to TC_MAX_M, lookups above) and each kernel alone
    agree with the plain version within 1e-5 (fp32 sums of 2m bf16
    entries in another order), one launch each."""
    rng = np.random.default_rng(m + n_q)
    codes = torch.from_numpy(rng.integers(0, 256, (n, m), dtype=np.uint8)).to(cuda)
    codes[100:140] = codes[3]
    lut = torch.from_numpy(
        rng.standard_normal((n_q, 2 * m, 16)).astype(np.float32) * 0.05
    ).to(cuda, torch.bfloat16)
    ref = k2.pq_segmax_reference(lut, codes)
    wide = m > k2.TC_MAX_M              # the lookup kernel alone
    launches = [k2.pq_segmax, k2._launch_lookup]
    if not wide:
        launches.append(k2._launch_tensor_cores)
    for launch in launches:
        before = k2.K2.launches
        got = launch(lut, codes)
        torch.cuda.synchronize()
        assert k2.K2.launches == before + 1
        assert got.shape == ref.shape == (n_q, -(-n // 8))
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


@pytest.mark.gpu
def test_pq_segmax_shared_memory_plan_matches_the_kernel(cuda):
    lib = k2.K2.library()
    for m in range(4, k2.MAX_M + 1, 4):
        for qt in k2.QUERY_TILES:
            for stages in (1, 2):
                assert lib.pq_segmax_smem_bytes(m, qt, stages) == \
                    k2.smem_bytes(m, qt, stages)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_rows", GPU_SEG_ROWS)
@pytest.mark.parametrize("n_q", [1, 8, 9, 64, 65, 128])
@pytest.mark.parametrize("m", [48, 304])
def test_pq_segmax_every_seg_rows_on_gpu(cuda, seg_rows, n_q, m):
    """Both kernels at every seg_rows they take, at the query tiles'
    edges, with m on both sides of TC_MAX_M and the last segment part
    full (rows past N masked inside it): the dispatch and each kernel
    alone agree with the plain version within 1e-5, one launch each."""
    assert m % 4 == 0 and (m > k2.TC_MAX_M) == (m == 304)
    n = 64 * 45 + 37
    rng = np.random.default_rng(seg_rows * 1000 + n_q + m)
    codes = torch.from_numpy(rng.integers(0, 256, (n, m), dtype=np.uint8)).to(cuda)
    codes[100:140] = codes[3]
    lut = torch.from_numpy(
        rng.standard_normal((n_q, 2 * m, 16)).astype(np.float32) * 0.05
    ).to(cuda, torch.bfloat16)
    ref = k2.pq_segmax_reference(lut, codes, seg_rows)
    launches = [k2.pq_segmax, k2._launch_lookup]
    if m <= k2.TC_MAX_M:
        launches.append(k2._launch_tensor_cores)
    for launch in launches:
        before = k2.K2.launches
        got = launch(lut, codes, seg_rows)
        torch.cuda.synchronize()
        assert k2.K2.launches == before + 1
        assert got.shape == ref.shape == (n_q, -(-n // seg_rows))
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_rows", GPU_SEG_ROWS)
def test_pq_topk_every_seg_rows_on_gpu(cuda, clustered, jax_cb, seg_rows):
    """pq_topk through K2 at every seg_rows against the same call on the
    CPU (the plain version), n_valid inside a segment."""
    docs, q = clustered
    codes = torch.from_numpy(jpq.encode_pq(docs, jax_cb))
    qr = torch.from_numpy(jax_cb.rotate(q))
    cbs = torch.from_numpy(jax_cb.codebooks)
    before = k2.K2.launches
    got = tpq.pq_topk(qr.to(cuda), codes.to(cuda), cbs.to(cuda), 20,
                      n_valid=1995, seg_rows=seg_rows)
    assert k2.K2.launches == before + 1
    ref = tpq.pq_topk(qr, codes, cbs, 20, n_valid=1995, seg_rows=seg_rows)
    assert_same_under_ties(got[0].cpu(), got[1].cpu(), ref[0], ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("seg_rows", [0, 65, 128])
def test_pq_segmax_refuses_other_seg_rows_on_gpu(cuda, seg_rows):
    lut = torch.zeros(8, 96, 16, dtype=torch.bfloat16, device=cuda)
    codes = torch.zeros(1000, 48, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="seg_rows"):
        k2.pq_segmax(lut, codes, seg_rows)


@pytest.mark.gpu
def test_pq_segmax_lookup_shared_memory_matches_the_kernel(cuda):
    lib = k2.K2.library()
    for m in (k2.TC_MAX_M + 4, 1000, k2.MAX_M):
        for sr in k2.SUPPORTED_SEG_ROWS:
            if k2.lookup_smem_bytes(m, 1, sr) > k2.MAX_SMEM:
                continue
            qt = k2.lookup_tile(m, 64, sr)
            assert lib.pq_segmax_lookup_smem_bytes(m, qt, sr) == \
                k2.lookup_smem_bytes(m, qt, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_rows", [3, 12])
def test_pq_topk_at_odd_seg_rows_on_gpu(cuda, clustered, jax_cb, seg_rows):
    """pq_topk at a seg_rows that is not a power of two runs K2 on the
    card (no refusal, no plain fallback) over 5,000 codes (m=8, 4
    queries, k=10) and equals the reference's top-10."""
    docs, q = clustered
    codes = jpq.encode_pq(np.tile(docs, (3, 1))[:5000], jax_cb)
    qr = jax_cb.rotate(q[:4])
    ref_s, ref_i = jpq.pq_topk(
        jnp.asarray(qr), jnp.asarray(codes), jnp.asarray(jax_cb.codebooks),
        10, seg_rows=seg_rows, interpret=True,
    )
    before = k2.K2.launches
    got_s, got_i = tpq.pq_topk(
        torch.from_numpy(qr).to(cuda), torch.from_numpy(codes).to(cuda),
        torch.from_numpy(jax_cb.codebooks).to(cuda), 10, seg_rows=seg_rows,
    )
    assert k2.K2.launches == before + 1
    assert_same_under_ties(got_s.cpu(), got_i.cpu(), ref_s, ref_i)
