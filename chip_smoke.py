#!/usr/bin/env python3
"""Smoke run of the PyTorch port (legal_rag_tpu_torch) on one CUDA card.

Phases, one output line each:

1. the card (name and power limit from nvidia-smi), the build of
   kernels K1, K2, K3, K4 and the probe P from the CUDA sources in this
   checkout (one nvcc each, started together), with ptxas's registers
   per instantiation, P launched on its tie input (33 expected), and
   P's launch path step by step on the host (scripts/launch_steps.py:
   ns a call of each step over 10,000 calls, torch.argmax beside it)
   with the kernel's device time from torch.profiler;
2. K1 against its plain PyTorch version at the main path's shapes
   (1,000,000 docs padded to 1,007,616 rows, D=384, 8, 64, 67 and 128
   queries: one request, a coalesced flush of 64 and of 64 plus a
   victim's 4, which the engine pads to 128, and 67 for direct ops
   callers; fp32 and bf16, odd n_valid, duplicate rows; at 64 queries
   also seg_rows 16 and D=100), the whole two-phase top-k against a
   float64 brute force, and both versions' times;
2b. K1's int8 variant against its plain version on phase 2's docs
   quantized per segment (8, 64, 67 and 128 queries): int32 maps bit-equal,
   the int8 two-phase top-20 equal to an int8-metric brute force, both
   versions' times;
2c. K2 against its plain version on 1,000,000 PQ codes (m=48) of a
   clustered corpus (8, 64 and 128 queries), pq_topk's top-20 against a
   float64 ADC brute
   force, and both versions' times there and on 10,000,000 codes; the
   same on 1,000,000 random codes at m=24 and m=96;
2d. the PQ/IVF recovery workload of scripts/exp_ivf_recovery.py on the
   card (1,048,576 clustered docs, 64 queries, post-rescore recall@10
   at oversample 64, flat and at 512 probes);
2e. K4 against its plain version on column-major docs (1,048,576 docs,
   D=384, 8, 16, 32, 64 and 128 queries, fp32 and bf16, seg_rows 8, 16,
   32 and 64, odd n_valid, duplicate columns; and 262,144 docs at
   D=1536, seg_rows 8 and 64), dense_topk_twophase's top-20 against a
   float64 brute force, both versions' times beside cuBLAS ``q @
   docs_t`` alone and the bound (fp32 counted as 3xTF32's three TF32
   products);
2f. K3 against its plain version (2,620, 65,536 and 1,007,616 docs, 8
   and 64 queries, k 10 and 64, fp32 and bf16, k=300 at 1,007,616 docs,
   k 10 and 300 at D=1536, and a masked tail with n_valid < k): scores
   within 1e-5 (4e-5 at D=1536) and ids equal under the tie-aware
   rule against the plain version's fp32 scores (the tensor cores sum
   in their own order), duplicate columns first by lowest id; times in
   turns (plain, kernel, kernel, plain) beside one PyTorch call of the
   same function (torch.topk over q @ docs_t, or over torch.mm(...,
   out_dtype=float32) for bf16; scripts/k3_shapes.py); then the fused entry
   points (ops.dense_topk(fused=True) over the 2,620-doc corpus,
   dense_topk_fused over 1,007,616 docs) with K3's launches counted;
2g. the port's bench_scale at its default sizes with the column-major
   row (matmul + top-k, K1's and K4's two-phase searches, bf16, 64
   queries, k=10): its table, recall of the K1 and K4 rows >= 0.999,
   and K1's and K4's launches over that run;
2h. the timing experiments' kernels: X1 (the stream probe) and X2 (the
   tensor-core matmul probe) against their plain versions on 1,000,000
   bf16 docs transposed ([384, N_pad]) at every block_n the roofline
   experiment sweeps (X1's block maxima bit-equal, its in-order sum
   within 1e-6 relative; X2 within 1e-5), cuBLAS ``q @ docs_t`` alone as
   a yardstick, K4 at seg_rows 32 against its plain version; then the
   six experiment scripts' run() at their default sizes (fewer timed
   calls): the row-major recall@10 >= 0.999, every full path's top-10
   equal to the flat select's under the tie rule, and K1's, K4's, X1's
   and X2's launches over that run;
3. a synthetic store made from --seed (default 1,000,000 docs) with
   its PQ and IVF artifacts, saved with the port's VectorStore.save
   under build/ and loaded back, and its late-interaction slab (32
   tokens a doc, float16, 24.6 GB at 1M docs) drawn on the card and
   written once in row chunks, memory-mapped;
4. the port's LegalEngine on the card behind the HTTP server: three
   POST /api/v1/query requests (victim narrative, procedural, heading)
   and one POST /api/v1/batch_search, each checked for its planted
   doc, with K1's launch count over exactly that run; then one
   batch_search of 64 queries (the coalescer's flush size) and one of
   68 (run at Q=128), which K1 must serve on its tensor-core kernel;
5. the same search_batch calls through a second engine on the CPU,
   equal to the card's under the tie-aware rule, the batches of 64 and
   68 included;
6. the PQ + IVF and the int8 engines behind the HTTP server (the same
   requests and checks; each answers maxsim-rerank with a 422), then
   the int8 and the flat PQ engines through search_batch, with K2's and
   K1-int8's launch counts over those runs;
7. each quantized tier's search_batch on the card equal to a CPU
   engine's under the tie-aware rule, and the int8 engine's weighted
   results equal to the fp32 engine's;
8. the late-interaction modes behind the HTTP server on the fp32
   engine (the slab uploaded as bf16): POST /api/v1/batch_search of
   the three PRIMARY queries, k=10, in maxsim-rerank and maxsim mode,
   planted docs first; the full scan's top-10 equal to a float64
   MaxSim brute force over the same bf16 slab, the rerank's to exact
   MaxSim over the dense stage's own top-20 (tie-aware, 1e-5 a real
   query token); K1 launched on every maxsim-rerank device search;
   stage times, the scan's GB/s at the engine's block and at 512, and
   its kernels by device time (torch.profiler); 8b the device postings
   gather (PRIMARY and the victim's expansions) equal to the host
   gather at the uncapped budget, both timed at the engine's budget;
   8c the port's bench_maxsim_scale at its defaults (131,072 docs, 64
   queries, Td=32);
9. the build path: a markdown corpus of the five laws (2,620 chunks,
   ingest.synthetic), ``ingest`` and ``build --finetune-steps 300
   --finetune-token-weight 0.5 --pq-m 48 --ivf-cell-size 256
   --rerank-steps 300 --multi-vector 32`` through the port's command
   line on the card (losses falling, the gate's verdict and alpha, the
   stage times), the store served by ``python -m legal_rag_tpu_torch
   serve`` in a process of its own, each of three titles' own chunks in
   its /api/v1/query context and its batch_search top 10; an untrained
   256-chunk build on the card equal to the CPU's (embeddings within
   1e-5, BM25 and corpus_hash equal); the encode throughput over 65,536
   chunks at batches 64 and 512 beside the fp32 FLOP bound, and the
   fine-tune and CE steps' ms.

Then a JSON line with each kernel's launches, error, times and bound
(K4 at fp32 Q=8 and at bench_scale's bf16 Q=64; K1 also on the
maxsim-rerank path),
and last ``{"ok": true, "device": {...}}``. Any failed check raises, so
the exit code is non-zero and that last line is not printed. No module
of the JAX package (``legal_rag_tpu``) may be loaded by the end.

Run from the repository root:  python3 chip_smoke.py [--docs N] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

VICTIM = ("I was robbed at gunpoint just now, what is the procedure and "
          "what are the rights of the victim?")
PROCEDURAL = "What is the procedure to file an FIR?"
HEADING = "punishment for robbery"
PRIMARY = (VICTIM, PROCEDURAL, HEADING)
# POST /api/v1/batch_search of 64 queries (the coalescer's flush size, so
# the served path launches K1 at Q=64) and of 68 (a flush of 64 plus a
# victim's 4, which the engine pads to Q=128: two query tiles)
SERVED_BATCHES = {n: tuple(f"{PRIMARY[i % 3]} (case {i})" for i in range(n))
                  for n in (64, 68)}

N_ROWS, N_VALID, DIM = 1_007_616, 1_000_000, 384
SEG_TOL = 1e-5      # K1 vs plain: fp32 sums of 384 products of unit-vector
                    # entries (|score| <= 1) in another order
PQ_TOL = 1e-5       # K2 vs plain: fp32 sums of 96 bf16 table entries
                    # (|score| ~ 1) in another order
PQ_M = 48
# K1's batches: one request (the engine pads it to 8), the coalescer's
# flush of 64, and 64 plus a victim's 4 queries, which the engine pads to
# 128 (two query tiles); 67 as a direct ops caller may pass it
K1_QS = (8, 64, 67, 128)
PQ_WIDTHS = (24, 96)   # more code widths K2 takes (D=384: 8 and 2 dims a subspace)
N_PQ, N_PQ_BIG = 1_000_000, 10_000_000
RECOVERY_N, RECOVERY_Q, RECOVERY_OVERSAMPLE = 1 << 20, 64, 64
RECOVERY_FLOOR = {"flat": 0.99, "ivf512": 0.94}      # the tier's recall floors
RECOVERY_REPO = {"flat": 1.0, "ivf512": 0.958}       # EVAL_IVF_RECOVERY.json
# RRF values change by at most this when a near-tie in one channel
# lets a doc trade one place with its neighbour
RRF_SWAP = 1.0 / 61 - 1.0 / 62
TOPK_TOL = 1e-5     # tie band of tests/test_dense.py
DENSE_TOL = 1e-5    # GPU vs CPU engine: query embeddings and dot products
                    # in fp32 with other summation orders
CM_TOL = 1e-5       # K4 vs plain: fp32 sums of 384 products in another order
# K4's batches (one query tile of 8-64, two of 64) and seg_rows at D=384
K4_QS, K4_SEG_ROWS = (8, 16, 32, 64, 128), (8, 16, 32, 64)
N_CM, N_CM_VALID = 1 << 20, 1_000_003     # K4's docs; an odd n_valid
N_K3 = (2_620, 65_536, 1_007_616)   # the serving corpus, LARGE_N_THRESHOLD,
                                    # the 1M store's padded rows
WIDE_D, N_WIDE = 1536, 262_144      # K3's and K4's widths past 1024
K3_BIG_K = 300                      # past the 256 K3 took before
# K3 and K4 vs plain at D=1536: fp32 sums of D products drift from one
# order to another in proportion to D (1e-5 per 384 dims; 2.1e-5 read
# at D=1536 in the GPU tests)
WIDE_TOL = TOPK_TOL * WIDE_D / DIM
K3_TOL = 1e-5
X1_SUM_RTOL = 1e-6  # X1's in-order sum vs plain's: fp32 adds of the same
                    # maxima (the card's cumsum may order them otherwise)
X2_TOL = 1e-5       # X2 vs plain: fp32 sums of 384 exact bf16 products of
                    # unit-vector entries, in the tensor cores' order
EXPERIMENTS = ("exp_dense_roofline", "exp_twophase_stages",
               "exp_twophase_rowmajor", "exp_rm_stages",
               "exp_select_variants", "exp_member_topk")
MV_TD = 32          # the token slab's budget (`build --multi-vector 32`)
MAXSIM_TOL = 1e-5   # MaxSim vs float64: per real query token (one fp32
                    # max of a 384-term sum of exact bf16 products)
MAXSIM_REPS = 3     # timed batch_search calls a MaxSim mode
# one H100 SXM, dense peak rates from NVIDIA's H100 data sheet
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                  "int8": 1979e12}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, n_ops: float, kind: str):
    """The least time the card could take for this work, ms: the larger
    of the bytes over the memory rate and the operations over the peak
    rate of their type; returns ``(ms, "bytes" | "operations")``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_topk_equiv(torch, q, docs, n_valid, k, got_s, got_i):
    """Tie-aware exact top-k against float64 (tests/test_dense.py rule)."""
    assert_topk_equiv_scores(torch, q.double() @ docs[:n_valid].double().T,
                             k, got_s, got_i)


def assert_topk_equiv_scores(torch, s64, k, got_s, got_i, tol=TOPK_TOL):
    """The tie-aware rule against given float64 scores ``s64 [Q, N]``:
    values rank by rank and each id's own score within ``tol``,
    descending, every id clearly above the k-th present, none clearly
    below it."""
    n_valid = s64.shape[1]
    srt = torch.topk(s64, k, dim=1).values
    kth = srt[:, k - 1:k]
    got_s = got_s.double()
    got_i = got_i.long()
    check(bool((got_i < n_valid).all()), "top-k returned a masked row")
    got_true = torch.gather(s64, 1, got_i)
    check(float((got_s - srt).abs().max()) <= tol, "top-k values")
    check(float((got_s - got_true).abs().max()) <= tol, "top-k scores")
    check(bool((got_s[:, 1:] - got_s[:, :-1] <= tol).all()), "order")
    check(bool((got_true >= kth - tol).all()), "id below the tie band")
    for qi in range(s64.shape[0]):
        check(len(set(got_i[qi].tolist())) == k, "repeated id")
        must = torch.nonzero(s64[qi] > kth[qi] + tol).flatten()
        check(set(must.tolist()) <= set(got_i[qi].tolist()), "missing hit")


def phase_kernel(torch, seed: int):
    from legal_rag_tpu_torch.utils.timing import time_ms
    from legal_rag_tpu_torch.ops.dense import (
        dense_topk_matmul, dense_topk_twophase_rm,
    )
    from legal_rag_tpu_torch.ops.segmax_rm import (
        segmax_rm, segmax_rm_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    docs32 = torch.randn(N_ROWS, DIM, generator=g, device=dev)
    docs32 /= docs32.norm(dim=1, keepdim=True)
    docs32[500_000:500_040] = docs32[123]       # duplicates across segments
    docs32[999_990:1_000_010] = docs32[77]      # duplicates across n_valid
    max_err, times = 0.0, {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        docs = docs32.to(dtype)
        for qp in K1_QS:
            q = torch.randn(qp, DIM, generator=g, device=dev)
            q /= q.norm(dim=1, keepdim=True)
            q[1] = docs32[123]
            q = q.to(dtype)
            for n_valid in (N_VALID, N_VALID + 3):
                got = segmax_rm(q, docs, n_valid)
                ref = segmax_rm_reference(q, docs, n_valid)
                torch.cuda.synchronize()
                check(got.shape == ref.shape == (qp, N_ROWS // 8), "K1 shape")
                check(bool(torch.isfinite(got).all()), "K1 non-finite")
                err = float((got - ref).abs().max())
                check(err <= SEG_TOL, f"K1 {tag} Q={qp} error {err}")
                max_err = max(max_err, err)
            s, i = dense_topk_twophase_rm(q, docs, 20, n_valid=N_VALID)
            assert_topk_equiv(torch, q.float(), docs.float(), N_VALID, 20, s, i)
            dup = set(i[1].tolist())
            check({123, *range(500_000, 500_019)} <= dup, "duplicate ties")
            k1 = lambda: segmax_rm(q, docs, N_VALID)
            plain = lambda: segmax_rm_reference(q, docs, N_VALID)
            p1, k1a, k1b, p2 = (time_ms(f) for f in (plain, k1, k1, plain))
            two = time_ms(lambda: dense_topk_twophase_rm(
                q, docs, 32, n_valid=N_VALID))
            full = time_ms(lambda: dense_topk_matmul(
                q, docs[:N_VALID], 32))
            times[(tag, qp)] = {
                "k1_ms": (k1a + k1b) / 2, "plain_ms": (p1 + p2) / 2,
                "twophase_ms": two, "matmul_topk_ms": full,
            }
        # the shapes the tensor-core kernel admits beyond the served
        # one: seg_rows 16 over these docs, and D=100 (their first 100
        # columns, renormalized), 64 queries, with the two-phase top-20
        q = unit_queries(torch, g, 64, docs32).to(dtype)
        narrow = docs32[:, :100] / docs32[:, :100].norm(dim=1, keepdim=True)
        narrow = narrow.to(dtype)
        q_narrow = (q.float()[:, :100] / q.float()[:, :100].norm(
            dim=1, keepdim=True)).to(dtype)
        for d_docs, d_q, seg_rows in ((docs, q, 16), (narrow, q_narrow, 8)):
            for n_valid in (N_VALID, N_VALID + 3):
                got = segmax_rm(d_q, d_docs, n_valid, seg_rows)
                ref = segmax_rm_reference(d_q, d_docs, n_valid, seg_rows)
                torch.cuda.synchronize()
                check(got.shape == ref.shape == (64, N_ROWS // seg_rows),
                      "K1 shape")
                err = float((got - ref).abs().max())
                check(err <= SEG_TOL, f"K1 {tag} D={d_docs.shape[1]} "
                      f"seg_rows {seg_rows}: error {err}")
                max_err = max(max_err, err)
            s, i = dense_topk_twophase_rm(d_q, d_docs, 20, n_valid=N_VALID,
                                          seg_rows=seg_rows)
            assert_topk_equiv(torch, d_q.float(), d_docs.float(), N_VALID,
                              20, s, i)
        del docs, narrow
    return max_err, times, docs32


def phase_kernel_int8(torch, docs32, seed: int):
    """K1-int8 against its plain version on ``docs32`` quantized per
    segment (the int8 tier's ShardedIndex); returns the times."""
    from legal_rag_tpu_torch.utils.timing import time_ms
    from legal_rag_tpu_torch.ops.dense import (
        dense_topk_twophase_rm, quantize_queries, sort_score_desc_id_asc,
    )
    from legal_rag_tpu_torch.ops.segmax_rm import (
        segmax_rm, segmax_rm_reference,
    )
    from legal_rag_tpu_torch.parallel.sharded import ShardedIndex

    dev = torch.device("cuda")
    idx = ShardedIndex.from_embeddings(docs32.cpu().numpy(), dtype="int8",
                                       device=dev)
    check(idx.docs.shape == (N_ROWS, DIM), "int8 index shape")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    max_err, times = 0, {}
    for qp in K1_QS:
        q = torch.randn(qp, DIM, generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        q[1] = docs32[123]
        q_i8, q_scale = quantize_queries(q)
        for n_valid in (N_VALID, N_VALID + 3):
            got = segmax_rm(q_i8, idx.docs, n_valid)
            ref = segmax_rm_reference(q_i8, idx.docs, n_valid)
            torch.cuda.synchronize()
            check(got.dtype == ref.dtype == torch.int32, "K1-int8 dtype")
            check(got.shape == (qp, N_ROWS // 8), "K1-int8 shape")
            check(torch.equal(got, ref), f"K1-int8 Q={qp} n_valid {n_valid}: "
                  f"{int((got != ref).sum())} map entries differ")
            max_err = max(max_err, int((got - ref).abs().max()))
        # the two-phase top-20 is the exact top-20 of the int8 metric
        s, i = dense_topk_twophase_rm(q, idx.docs, 20, n_valid=N_VALID,
                                      doc_scales=idx.doc_scales)
        acc = q_i8.float() @ idx.docs[:N_VALID].float().T
        full = acc * q_scale[:, None] * idx.doc_scales[:N_VALID][None, :]
        ids = torch.arange(N_VALID, device=dev).expand(qp, N_VALID)
        want_s, want_i = sort_score_desc_id_asc(full, ids)
        check(torch.equal(i.long(), want_i[:, :20]), "int8 top-20 ids")
        check(torch.equal(s, want_s[:, :20]), "int8 top-20 scores")
        k1 = lambda: segmax_rm(q_i8, idx.docs, N_VALID)
        plain = lambda: segmax_rm_reference(q_i8, idx.docs, N_VALID)
        p1, k1a, k1b, p2 = (time_ms(f) for f in (plain, k1, k1, plain))
        two = time_ms(lambda: dense_topk_twophase_rm(
            q, idx.docs, 32, n_valid=N_VALID, doc_scales=idx.doc_scales))
        times[qp] = {"k1_ms": (k1a + k1b) / 2, "plain_ms": (p1 + p2) / 2,
                     "twophase_ms": two}
    return max_err, times


def recovery_corpus(seed: int):
    """scripts/exp_ivf_recovery.py's corpus: 2048 Gaussian centers,
    docs = center + 0.3 noise, queries = a doc + 0.05 noise, unit rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, q, d = RECOVERY_N, RECOVERY_Q, DIM
    centers = rng.standard_normal((2048, d)).astype(np.float32)
    docs = centers[rng.integers(0, 2048, n)] + 0.3 * (
        rng.standard_normal((n, d)).astype(np.float32)
    )
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = docs[rng.integers(0, n, q)] + 0.05 * (
        rng.standard_normal((q, d)).astype(np.float32)
    )
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return docs, qs


def adc_scores64(torch, lut64, codes, block: int = 8192):
    """float64 ADC brute force: ``[Q, N]`` sums of the table entries."""
    from legal_rag_tpu_torch.ops.pq_segmax import unpack_nibbles

    q, n_sub, _ = lut64.shape
    flat = lut64.reshape(q, n_sub * 16)
    base = torch.arange(n_sub, device=codes.device) * 16
    out = torch.empty((q, codes.shape[0]), dtype=torch.float64,
                      device=codes.device)
    for lo in range(0, codes.shape[0], block):
        idx = unpack_nibbles(codes[lo:lo + block]) + base
        out[:, lo:lo + idx.shape[0]] = flat[:, idx].sum(dim=2)
    return out


def phase_pq(torch, seed: int):
    """K2 against its plain version and the recovery workload, on the
    recovery corpus trained and coded by the port on the card."""
    from legal_rag_tpu_torch.utils.timing import time_ms
    import numpy as np

    from legal_rag_tpu_torch.ops.dense import exact_rescore
    from legal_rag_tpu_torch.ops.pq import (
        build_ivf, encode_pq, pq_ivf_topk, pq_lut, pq_topk, train_pq,
    )
    from legal_rag_tpu_torch.ops.pq_segmax import (
        pq_segmax, pq_segmax_reference,
    )

    dev = torch.device("cuda")
    t0 = time.time()
    docs, qs = recovery_corpus(seed)
    t_data = time.time() - t0
    t0 = time.time()
    cb = train_pq(docs, m=PQ_M, iters=15, sample=32768, opq_iters=4,
                  device=dev)
    codes = encode_pq(docs, cb, device=dev)
    ivf = build_ivf(docs, cb, codes, cell_size=1024, device=dev)
    t_train = time.time() - t0
    check(ivf.n_cells == RECOVERY_N // 1024, "IVF cells")

    # -- K2 against its plain version, and pq_topk against float64 ADC
    codes_d = torch.from_numpy(codes).to(dev)
    codes_1m = codes_d[:N_PQ]
    cbs = torch.from_numpy(cb.codebooks).to(dev)
    qrot = torch.from_numpy(cb.rotate(qs)).to(dev)
    max_err, times = 0.0, {}
    for qp in (8, 64, 128):
        # 128 queries: the recovery workload's 64 twice
        q = qrot[torch.arange(qp, device=dev) % qrot.shape[0]].contiguous()
        lut = pq_lut(q, cbs).to(torch.bfloat16).contiguous()
        got = pq_segmax(lut, codes_1m)
        ref = pq_segmax_reference(lut, codes_1m)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (qp, N_PQ // 8), "K2 shape")
        check(bool(torch.isfinite(got).all()), "K2 non-finite")
        err = float((got - ref).abs().max())
        check(err <= PQ_TOL, f"K2 Q={qp} error {err}")
        max_err = max(max_err, err)
        s, i = pq_topk(q, codes_1m, cbs, 20)
        lut64 = torch.einsum("qmd,mcd->qmc",
                             q.double().reshape(qp, 2 * PQ_M, -1),
                             cbs.double())
        assert_topk_equiv_scores(torch, adc_scores64(torch, lut64, codes_1m),
                                 20, s, i)
        k2 = lambda: pq_segmax(lut, codes_1m)
        plain = lambda: pq_segmax_reference(lut, codes_1m)
        p1, ka, kb, p2 = (time_ms(f) for f in (plain, k2, k2, plain))
        top = time_ms(lambda: pq_topk(q, codes_1m, cbs, 20))
        times[(N_PQ, qp)] = {"k2_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                             "pq_topk_ms": top}
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    big = torch.randint(0, 256, (N_PQ_BIG, PQ_M), generator=g, device=dev,
                        dtype=torch.uint8)
    for qp in (8, 64):
        lut = pq_lut(qrot[:qp], cbs).to(torch.bfloat16).contiguous()
        k2 = lambda: pq_segmax(lut, big)
        plain = lambda: pq_segmax_reference(lut, big)
        p1, ka, kb, p2 = (time_ms(f, iters=5, warmup=1)
                          for f in (plain, k2, k2, plain))
        times[(N_PQ_BIG, qp)] = {"k2_ms": (ka + kb) / 2,
                                 "plain_ms": (p1 + p2) / 2}
    del big

    # -- K2 at other code widths: random codes and seeded codebooks,
    # against the plain version and pq_topk's top-20 against float64 ADC
    times_w = {}
    for m in PQ_WIDTHS:
        codes_m = torch.randint(0, 256, (N_PQ, m), generator=g, device=dev,
                                dtype=torch.uint8)
        cbs_m = torch.randn(2 * m, 16, DIM // (2 * m), generator=g,
                            device=dev) * 0.1
        for qp in (8, 64):
            q = qrot[:qp].contiguous()
            lut = pq_lut(q, cbs_m).to(torch.bfloat16).contiguous()
            got = pq_segmax(lut, codes_m)
            ref = pq_segmax_reference(lut, codes_m)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (qp, N_PQ // 8), "K2 shape")
            err = float((got - ref).abs().max())
            check(err <= PQ_TOL, f"K2 m={m} Q={qp} error {err}")
            max_err = max(max_err, err)
            k2 = lambda: pq_segmax(lut, codes_m)
            plain = lambda: pq_segmax_reference(lut, codes_m)
            p1, ka, kb, p2 = (time_ms(f) for f in (plain, k2, k2, plain))
            times_w[(m, qp)] = {"k2_ms": (ka + kb) / 2,
                                "plain_ms": (p1 + p2) / 2}
        q = qrot[:8].contiguous()
        s, i = pq_topk(q, codes_m, cbs_m, 20)
        lut64 = torch.einsum("qmd,mcd->qmc",
                             q.double().reshape(8, 2 * m, -1), cbs_m.double())
        assert_topk_equiv_scores(torch, adc_scores64(torch, lut64, codes_m),
                                 20, s, i)
        del codes_m

    # -- recovery: post-rescore recall@10 at oversample 64
    k = 10
    kk = k * RECOVERY_OVERSAMPLE
    sc = qrot.new_tensor(qs) @ torch.from_numpy(docs).to(dev).T
    gold = torch.sort(sc, dim=1, descending=True, stable=True).indices[:, :k]
    gold = [set(row) for row in gold.cpu().tolist()]
    del sc
    recall = {}
    for name in ("flat", "ivf512"):
        if name == "flat":
            _, cand = pq_topk(qrot, codes_d, cbs, kk)
        else:
            _, cand = pq_ivf_topk(qrot, ivf, cb.codebooks, kk, probes=512)
        _, top, _, _ = exact_rescore(qs, cand.cpu().numpy(), docs, k=k)
        recall[name] = float(np.mean([
            len(set(row.tolist()) & want) / k for row, want in zip(top, gold)
        ]))
        check(recall[name] >= RECOVERY_FLOOR[name],
              f"recovery {name}: recall@10 {recall[name]} < "
              f"{RECOVERY_FLOOR[name]}")
    return max_err, times, recall, (t_data, t_train), times_w


def phase_probe(torch) -> dict:
    """P on its tie input: equal to its plain version and 33 on every
    row; its launches over exactly that call, the times of the kernel,
    the plain version and torch.argmax, and the host steps of one call
    with the kernel's device time (scripts/launch_steps.py)."""
    from legal_rag_tpu_torch.scripts import launch_steps
    from legal_rag_tpu_torch.utils.timing import time_ms
    from legal_rag_tpu_torch.ops.argmax_probe import (
        probe_input, row_argmax, row_argmax_reference,
    )

    x = probe_input("cuda")
    reset_counts()
    got = row_argmax(x)
    torch.cuda.synchronize()
    launches = read_counts()["P"]
    check(torch.equal(got, row_argmax_reference(x))
          and got.tolist() == [33] * 8, f"P gave {got.tolist()}")
    kernel = lambda: row_argmax(x)
    library = lambda: torch.argmax(x, dim=1)
    # a call costs ~10 us of host time: 1,000 calls a reading, in turns
    l1, ka, kb, l2 = (time_ms(f, iters=1000, warmup=50)
                      for f in (library, kernel, kernel, library))
    return {"rows": 33, "launches": launches, "ms": (ka + kb) / 2,
            "plain_ms": time_ms(lambda: row_argmax_reference(x), iters=200,
                                warmup=10),
            "library_ms": (l1 + l2) / 2, "steps": launch_steps.run()}


def colmajor_docs(torch, seed: int):
    """``[N_CM, DIM]`` fp32 unit rows on the card with duplicate docs
    across segments and across ``N_CM_VALID``."""
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    docs = torch.randn(N_CM, DIM, generator=g, device="cuda")
    docs /= docs.norm(dim=1, keepdim=True)
    docs[500_000:500_040] = docs[123]
    docs[999_990:1_000_010] = docs[77]
    return docs


def unit_queries(torch, g, qp: int, docs32):
    q = torch.randn(qp, DIM, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    q[1] = docs32[123]
    return q


def wide_docs(torch, seed: int):
    """``[WIDE_D, N_WIDE]`` fp32 unit columns on the card (docs_t)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    x = torch.randn(WIDE_D, N_WIDE, generator=g, device="cuda")
    return x / x.norm(dim=0, keepdim=True)


def phase_k4(torch, docs32, wide_t, seed: int):
    """K4 against its plain version at every K4_QS and K4_SEG_ROWS, and
    dense_topk_twophase's top-20 against float64 (and at D=1536 and
    seg_rows 8 and 64 over ``wide_t``); times at seg_rows 8 for every Q
    and at Q=64 for every seg_rows, beside cuBLAS ``q @ docs_t`` alone
    and the bound; returns the max error and the times."""
    from legal_rag_tpu_torch.utils.timing import time_ms
    from legal_rag_tpu_torch.ops.dense import dense_topk_twophase
    from legal_rag_tpu_torch.ops.segmax_cm import (
        n_segments, segmax_cm, segmax_cm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    max_err, times = 0.0, {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        docs_t = docs32.T.contiguous().to(dtype)
        elt = docs_t.element_size()
        for qp in K4_QS:
            q = unit_queries(torch, g, qp, docs32).to(dtype)
            cublas_ms = time_ms(lambda: q @ docs_t)
            for seg_rows in K4_SEG_ROWS:
                for n_valid in (N_CM, N_CM_VALID):
                    got = segmax_cm(q, docs_t, n_valid, seg_rows)
                    ref = segmax_cm_reference(q, docs_t, n_valid, seg_rows)
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape
                          == (qp, n_segments(N_CM, seg_rows)), "K4 shape")
                    check(bool(torch.isfinite(got).all()), "K4 non-finite")
                    err = float((got - ref).abs().max())
                    check(err <= CM_TOL, f"K4 {tag} Q={qp} seg_rows "
                          f"{seg_rows} n_valid {n_valid}: error {err}")
                    max_err = max(max_err, err)
                if seg_rows != 8 and qp != 64:
                    continue
                k4 = lambda: segmax_cm(q, docs_t, N_CM, seg_rows)
                plain = lambda: segmax_cm_reference(q, docs_t, N_CM, seg_rows)
                p1, ka, kb, p2 = (time_ms(f)
                                  for f in (plain, k4, k4, plain))
                # fp32 products as 3xTF32 computes them: three TF32 each
                times[(tag, qp, seg_rows)] = {
                    "k4_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                    "cublas_ms": cublas_ms,
                    "bound": bound(
                        N_CM * DIM * elt + qp * DIM * elt
                        + qp * n_segments(N_CM, seg_rows) * 4,
                        (3 if tag == "fp32" else 1) * 2 * qp * N_CM * DIM,
                        "tf32" if tag == "fp32" else "bf16"),
                }
            if qp not in (8, 64):
                continue
            s, i = dense_topk_twophase(q, docs_t, 20, n_valid=N_CM_VALID)
            assert_topk_equiv(torch, q.float(), docs_t.T.float(), N_CM_VALID,
                              20, s, i)
            check({123, *range(500_000, 500_019)} <= set(i[1].tolist()),
                  "K4 two-phase: duplicate ties")
            times[(tag, qp, 8)]["twophase_ms"] = time_ms(
                lambda: dense_topk_twophase(q, docs_t, 32))
        del docs_t
        wide = wide_t.to(dtype)
        for qp in (8, 64):
            q = torch.randn(qp, WIDE_D, generator=g, device="cuda")
            q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
            for seg_rows in (8, 64):
                got = segmax_cm(q, wide, N_WIDE - 5, seg_rows)
                ref = segmax_cm_reference(q, wide, N_WIDE - 5, seg_rows)
                torch.cuda.synchronize()
                check(got.shape == ref.shape, "K4 wide shape")
                err = float((got - ref).abs().max())
                check(err <= WIDE_TOL, f"K4 {tag} D={WIDE_D} Q={qp} seg_rows "
                      f"{seg_rows}: error {err}")
                max_err = max(max_err, err)
        s, i = dense_topk_twophase(q, wide, 20, n_valid=N_WIDE - 5)
        assert_topk_equiv_scores(
            torch, q.double() @ wide[:, :N_WIDE - 5].double(), 20, s, i,
            tol=WIDE_TOL)
        del wide
    return max_err, times


def phase_k3(torch, docs32, wide_t, seed: int):
    """K3 against its plain version (scores within K3_TOL, ids equal
    under the tie-aware rule against the plain version's fp32 scores,
    duplicate columns tied to the lowest id); returns the max error, the
    times of scripts/k3_shapes.py's time_shape at every shape (plain,
    kernel, kernel, plain, and the one-call yardstick) and the cases."""
    from legal_rag_tpu_torch.ops.fused_topk import (
        fused_scores_reference, fused_topk,
    )
    from legal_rag_tpu_torch.scripts.k3_shapes import time_shape

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    max_err, times, cases = 0.0, {}, 0

    def compare(q, docs_t, k, n_valid=None, what="", tol=K3_TOL):
        nonlocal max_err, cases
        got_s, got_i = fused_topk(q, docs_t, k, n_valid)
        scores = fused_scores_reference(q, docs_t, n_valid)
        torch.cuda.synchronize()
        check(got_s.shape == got_i.shape == (q.shape[0], k), f"K3 shape {what}")
        limit = scores.shape[1] if n_valid is None else n_valid
        m = min(k, limit)
        assert_topk_equiv_scores(torch, scores[:, :limit].double(), m,
                                 got_s[:, :m], got_i[:, :m], tol=tol)
        err = float((got_s - torch.topk(scores, k, dim=1).values).abs().max())
        check(err <= tol, f"K3 scores {what}: error {err}")
        max_err = max(max_err, err)
        cases += 1
        return got_s, got_i

    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        full = docs32.T.contiguous().to(dtype)
        for n in N_K3:
            docs_t = full[:, :n]          # a column slice: row stride N_CM
            for qp in (8, 64):
                q = unit_queries(torch, g, qp, docs32).to(dtype)
                for k in (10, 64):
                    s, i = compare(q, docs_t, k, what=f"{tag} N={n} Q={qp} k={k}")
                    if n > 500_040:
                        dups = [123, *range(500_000, 500_000 + min(k - 1, 40))]
                        check(i[1, :len(dups)].tolist() == dups
                              and len(set(s[1, :len(dups)].tolist())) == 1,
                              f"K3 duplicate ties {tag} N={n} Q={qp} k={k}")
                times[(tag, n, qp, 10)] = time_shape(q, docs_t, 10)
        # k past 256 at the 1M store's rows, and D=1536
        docs_t = full[:, :N_K3[2]]
        for qp in (8, 64):
            q = unit_queries(torch, g, qp, docs32).to(dtype)
            compare(q, docs_t, K3_BIG_K, what=f"{tag} k={K3_BIG_K} Q={qp}")
            times[(tag, N_K3[2], qp, K3_BIG_K)] = time_shape(q, docs_t,
                                                            K3_BIG_K)
        wide = wide_t.to(dtype)
        for qp in (8, 64):
            q = torch.randn(qp, WIDE_D, generator=g, device="cuda")
            q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
            for k in (10, K3_BIG_K):
                compare(q, wide, k, what=f"{tag} D={WIDE_D} Q={qp} k={k}",
                        tol=WIDE_TOL)
        del wide
        # the masked tail: n_valid < k, masked ids ascending at finfo.min
        q = unit_queries(torch, g, 8, docs32).to(dtype)
        s, i = compare(q, full[:, :N_K3[0]], 64, n_valid=40,
                       what=f"{tag} masked tail")
        check(bool((i[:, 40:] == torch.arange(40, 64, device="cuda")).all()),
              "K3 masked tail ids")
        check(bool((s[:, 40:] == torch.finfo(torch.float32).min).all()),
              "K3 masked tail scores")
        del full
    return max_err, times, cases


def phase_k3_path(torch, docs32, seed: int):
    """The fused entry points as a user calls them: ops.dense_topk(
    fused=True) over the 2,620-doc corpus (row-major docs) and
    dense_topk_fused over 1,007,616 column-major docs, each top-10
    exact under the tie rule; returns K3's launches over exactly that."""
    import legal_rag_tpu_torch.ops as ops

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    q = unit_queries(torch, g, 8, docs32)
    small = docs32[:N_K3[0]].contiguous()
    big_t = docs32[:N_K3[2]].T.contiguous()
    reset_counts()
    s1, i1 = ops.dense_topk(q, small, 10, fused=True)
    s2, i2 = ops.dense_topk_fused(q, big_t, 10)
    torch.cuda.synchronize()
    launches = read_counts()["K3"]
    assert_topk_equiv(torch, q, small, N_K3[0], 10, s1, i1)
    assert_topk_equiv(torch, q, docs32, N_K3[2], 10, s2, i2)
    check(launches == 2, f"K3 launched {launches}x on its entry points")
    return launches


def phase_bench(torch):
    """bench_scale at its default sizes with the column-major row;
    returns its rows and K1's and K4's launches over that run."""
    from legal_rag_tpu_torch.scripts import bench_scale

    reset_counts()
    rows = bench_scale.run(bench_scale.DEFAULT_SIZES, "cuda", include_cm=True,
                           log=lambda line: print(f"  bench_scale {line}",
                                                  flush=True))
    torch.cuda.synchronize()
    counts = read_counts()
    for r in rows:
        if "recall" in r and r["name"] != "matmul + top-k":
            check(r["recall"] >= 0.999, f"bench_scale {r['name']} N={r['n']}"
                  f": recall {r['recall']} < 0.999")
    check(counts["K1"] > 0 and counts["K4"] > 0, f"bench_scale launches "
          f"{counts}")
    return rows, counts


def phase_probes(torch, seed: int):
    """X1 and X2 against their plain versions on the roofline
    experiment's data at every block_n it sweeps, cuBLAS ``q16 @
    docs_t`` alone, and K4 at seg_rows 32 against its plain version;
    returns the times per block_n, cuBLAS's time and K4's max error."""
    from legal_rag_tpu_torch.utils.timing import time_ms
    from legal_rag_tpu_torch.ops.mm_rowmax import (
        mm_rowmax, mm_rowmax_reference,
    )
    from legal_rag_tpu_torch.ops.segmax_cm import (
        n_segments, segmax_cm, segmax_cm_reference,
    )
    from legal_rag_tpu_torch.ops.stream_probe import (
        stream_probe, stream_probe_reference,
    )
    from legal_rag_tpu_torch.scripts import exp_dense_roofline as roof

    n = roof.N
    q16, dt16 = roof.make_data(n, "cuda", seed)
    x1, x2 = {}, {}
    for bn in roof.STREAM_BN:
        dpad = roof.pad_cols(dt16, bn)
        nb = dpad.shape[1] // bn
        got_m, got_t = stream_probe(dpad, bn)
        ref_m, ref_t = stream_probe_reference(dpad, bn)
        torch.cuda.synchronize()
        check(got_m.shape == (nb,) and torch.equal(got_m, ref_m),
              f"X1 bn={bn}: {int((got_m != ref_m).sum())} block maxima differ")
        rel = abs(float(got_t) - float(ref_t)) / abs(float(ref_t))
        check(rel <= X1_SUM_RTOL, f"X1 bn={bn}: sum rel err {rel}")
        kernel = lambda: stream_probe(dpad, bn)
        plain = lambda: stream_probe_reference(dpad, bn)
        p1, ka, kb, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
        x1[bn] = {"ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                  "sum_rel_err": rel,
                  "library_ms": time_ms(lambda: dpad.view(
                      DIM, nb, bn).amax(dim=(0, 2))),
                  "bound": bound(dpad.numel() * 2 + nb * 4 + 4, dpad.numel(),
                                 "fp32")}
        del dpad
    for bn in roof.MATMUL_BN:
        dpad = roof.pad_cols(dt16, bn)
        nb = dpad.shape[1] // bn
        got = mm_rowmax(q16, dpad, bn)
        ref = mm_rowmax_reference(q16, dpad, bn)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (q16.shape[0], nb), "X2 shape")
        err = float((got - ref).abs().max())
        check(err <= X2_TOL, f"X2 bn={bn}: error {err}")
        kernel = lambda: mm_rowmax(q16, dpad, bn)
        plain = lambda: mm_rowmax_reference(q16, dpad, bn)
        p1, ka, kb, p2 = (time_ms(f, iters=10, warmup=2)
                          for f in (plain, kernel, kernel, plain))
        x2[bn] = {"ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2, "err": err,
                  "bound": bound((q16.numel() + dpad.numel()) * 2
                                 + q16.shape[0] * nb * 4,
                                 2 * q16.shape[0] * dpad.numel(), "bf16")}
        if bn == roof.MATMUL_BN[0]:
            cublas = time_ms(lambda: q16 @ dpad)
        del dpad
    # K4 at seg_rows 32, bf16 at 64 queries and fp32 at 8, odd n_valid
    k4_err = 0.0
    for docs_t, q in ((dt16, q16), (dt16.float(), q16[:8].float())):
        for n_valid in (n, n - 4097):
            got = segmax_cm(q, docs_t, n_valid, 32)
            ref = segmax_cm_reference(q, docs_t, n_valid, 32)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (q.shape[0], n_segments(n, 32)),
                  "K4 seg_rows 32 shape")
            err = float((got - ref).abs().max())
            check(err <= CM_TOL, f"K4 seg_rows 32 {docs_t.dtype} Q="
                  f"{q.shape[0]} n_valid {n_valid}: error {err}")
            k4_err = max(k4_err, err)
    return x1, x2, cublas, k4_err


def phase_experiments(torch):
    """The six experiment scripts' run() at their default sizes, 5 timed
    calls after 1 warm-up a row; returns their rows and the launches
    over exactly that run."""
    import importlib

    reset_counts()
    t0 = time.time()
    rows = {}
    for name in EXPERIMENTS:
        script = importlib.import_module(f"legal_rag_tpu_torch.scripts.{name}")
        rows[name] = script.run(
            device="cuda", iters=5, warmup=1,
            log=lambda line, name=name: print(f"  {name}: {line}", flush=True))
    torch.cuda.synchronize()
    counts = read_counts()
    for name, script_rows in rows.items():
        for r in script_rows:
            check(r.get("match", True), f"{name} {r['name']}: top-10 differs "
                  f"from the flat select's")
    recall = [r["recall"] for r in rows["exp_twophase_rowmajor"] if "recall" in r]
    check(len(recall) == 1 and recall[0] >= 0.999,
          f"exp_twophase_rowmajor recall@10 {recall}")
    for kernel in ("K1", "K4", "X1", "X2"):
        check(counts[kernel] > 0, f"the experiments never launched {kernel}: "
              f"{counts}")
    return rows, counts, recall[0], time.time() - t0


def post(url: str, payload) -> dict:
    status, body = post_status(url, payload)
    check(status == 200, f"{url}: HTTP {status}: {body}")
    return body


def post_status(url: str, payload):
    """``(HTTP status, JSON body)`` of a POST, error statuses included."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def channel_scores(store, encoder, queries, cap, sparse_all_docs):
    """Per query: every doc's dense score (fp32 matmul, accurate to
    ~1e-7), its BM25 total in float64 from the same budget-capped
    postings the engines score, the sparse candidate pool, and the BM25
    tolerance. ``sparse_all_docs``: on the scatter path every doc
    (zero scores included) competes for the sparse list; on the
    segment-sum path only docs with a posting do."""
    import numpy as np

    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2

    emb = encoder.encode(list(queries))
    dense = np.asarray(store.embeddings) @ emb.T                 # [N, Q]
    budget = _pad_pow2(store.bm25.postings_budget(queries, cap=cap))
    ids, w = store.bm25.gather_postings(queries, budget)
    out = []
    for qi in range(len(queries)):
        ok = (ids[qi] >= 0) & (ids[qi] < store.n_docs)
        bm = np.bincount(ids[qi][ok], weights=w[qi][ok].astype(np.float64),
                         minlength=store.n_docs)
        pool = (np.ones(store.n_docs, bool) if sparse_all_docs else
                np.bincount(ids[qi][ok], minlength=store.n_docs) > 0)
        # segment-sum totals are differences of fp32 prefix sums: their
        # error scales with the largest prefix (16 ulps of it here)
        tol = 4e-6 * float(np.abs(w[qi][ok]).sum()) + 1e-6
        out.append((dense[:, qi].astype(np.float64), bm, pool, tol))
    return out


def _rank_range(scores, s, tol):
    """1-based ranks a doc scoring ``s`` can take among ``scores`` when
    scores within ``tol`` of each other may come in either order."""
    return 1 + int((scores > s + tol).sum()), int((scores >= s - tol).sum())


def _bm25_max(channels):
    _, bm, pool, _ = channels
    gmax = float(bm[pool].max()) if pool.any() else 0.0
    return gmax if gmax > 0 else 1.0


def fused_tol(channels, mode, weight):
    """Weighted fusion carries the BM25 total's prefix-sum error, scaled
    by the weight and the max-normalization; RRF values are exact."""
    if mode != "weighted":
        return DENSE_TOL
    return DENSE_TOL + weight * channels[3] / _bm25_max(channels)


def assert_rows_exact(rows, channels, mode, weight, c, rrf_k, what):
    """Each returned doc's fused score is what its exact channel scores
    give it, with tied docs free to take any rank in their tie group:
    weighted = dense*(1-w) + bm25/max*w over the dense top-c; RRF =
    sum over the dense and sparse top-c lists of 1/(rrf_k + rank)."""
    dense, bm, pool, tol_s = channels
    gmax = _bm25_max(channels)
    for rank, r in enumerate(rows):
        d = r.doc_id
        where = f"{what}: rank {rank} doc {d} fused {r.score!r}"
        lo, _ = _rank_range(dense, dense[d], DENSE_TOL)
        if mode == "weighted":
            check(lo <= c, f"{where}: not a dense top-{c} candidate")
            want = dense[d] * (1 - weight) + bm[d] / gmax * weight
            check(abs(r.score - want) <= fused_tol(channels, mode, weight),
                  f"{where}: want {want!r}")
            continue
        f_lo = f_hi = 0.0
        for scores, in_pool, tol, s in (
            (dense, None, DENSE_TOL, dense[d]),
            (bm[pool], pool[d], tol_s, bm[d]),
        ):
            if in_pool is False:
                continue
            r_lo, r_hi = _rank_range(scores, s, tol)
            if r_lo <= c:
                f_hi += 1.0 / (rrf_k + r_lo)
            if r_hi <= c:
                f_lo += 1.0 / (rrf_k + r_hi)
        check(f_lo - 1e-6 <= r.score <= f_hi + 1e-6,
              f"{where}: exact channel ranks allow [{f_lo!r}, {f_hi!r}]")


def assert_equal_under_ties(dev_rows, cpu_rows, channels, mode, weights,
                            c, rrf_k, what):
    """The card's and the CPU's rows: fused scores equal rank by rank
    (within ``fused_tol``), and every doc on either side placed as its
    exact channel scores allow (docs that tie may trade places).
    Returns the number of ranks whose ids differ."""
    swaps = 0
    for qi, (g, h) in enumerate(zip(dev_rows, cpu_rows)):
        check(len(g) == len(h), f"{what}: query {qi}: result counts differ")
        tol = fused_tol(channels[qi], mode, weights[qi])
        for rank, (a, b) in enumerate(zip(g, h)):
            check(abs(a.score - b.score) <= tol,
                  f"{what}: query {qi} rank {rank}: card doc {a.doc_id} "
                  f"fused {a.score!r} vs cpu doc {b.doc_id} fused "
                  f"{b.score!r}; card {[(r.doc_id, r.score) for r in g]}, "
                  f"cpu {[(r.doc_id, r.score) for r in h]}")
            swaps += a.doc_id != b.doc_id
        for side, rows in (("card", g), ("cpu", h)):
            assert_rows_exact(rows, channels[qi], mode, weights[qi], c,
                              rrf_k, f"{what} {side} query {qi}")
    return swaps


def phase_store(n_docs: int, seed: int, device: str):
    """The synthetic store with its PQ/IVF artifacts and a token slab
    of ``MV_TD`` tokens a doc. The slab is written once, in row chunks,
    by ``synthesize_store`` into its own directory; the store saves and
    loads without it (``save`` would write a second copy) and gets it
    back memory-mapped, as ``VectorStore.load`` maps a store's slab."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.classifier import QueryClassifier
    from legal_rag_tpu_torch.retrieval.orchestrator import expansion_queries

    t0 = time.time()
    expansions = expansion_queries(QueryClassifier().classify(VICTIM))
    store = synthesize_store(
        n_docs, seed=seed, planted=PRIMARY, vocab_queries=expansions,
        device=device, multi_vector=MV_TD,
        mv_dir=os.path.join(REPO_ROOT, "build", "smoke_mv"),
    )
    slab = (store.mv_tokens, store.mv_mask)
    store.mv_tokens = store.mv_mask = None
    store_dir = os.path.join(REPO_ROOT, "build", "smoke_store")
    store.save(store_dir)
    del store
    store = VectorStore.load(store_dir)
    store.mv_tokens, store.mv_mask = slab
    print(f"phase 3 ok: {store.n_docs} docs, {len(store.bm25.doc_ids)} "
          f"postings, BM25 vocab {store.bm25.vocab_size}, mean length "
          f"{store.bm25.avgdl:.1f} tokens, WordPiece vocab "
          f"{len(store.wp_vocab)}, token slab {list(store.mv_tokens.shape)} "
          f"float16 ({store.mv_tokens.nbytes / 1e9:.2f} GB, mean "
          f"{float(store.mv_mask.mean()) * MV_TD:.1f} real tokens a doc); "
          f"built, saved and loaded in {time.time() - t0:.1f} s", flush=True)
    return store, expansions


def reset_counts() -> None:
    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.mm_rowmax import X2
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1
    from legal_rag_tpu_torch.ops.stream_probe import X1

    K1.launches = K1.int8_launches = K1.tensor_core_launches = K2.launches = 0
    K3.launches = K4.launches = P.launches = X1.launches = X2.launches = 0


def read_counts() -> dict:
    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.mm_rowmax import X2
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1
    from legal_rag_tpu_torch.ops.stream_probe import X1

    return {"K1": K1.launches, "K1-int8": K1.int8_launches,
            "K1 tensor cores": K1.tensor_core_launches,
            "K2": K2.launches, "K3": K3.launches, "K4": K4.launches,
            "P": P.launches, "X1": X1.launches, "X2": X2.launches}


def tier_config(dtype: str, **dense):
    import dataclasses

    from legal_rag_tpu_torch.retrieval.engine import DEFAULT_CONFIG

    return dataclasses.replace(DEFAULT_CONFIG, dense=dataclasses.replace(
        DEFAULT_CONFIG.dense, dtype=dtype, **dense))


def pq_ivf_config():
    """The documented 1M settings of the PQ + IVF tier (config.py:40-51):
    512 probes with 64x oversampling."""
    return tier_config("pq", ivf_probes=512, pq_oversample=64)


def phase_serve(store, n_docs: int, device: str, config=None,
                kernel: str = "K1", phase: int = 4):
    """Drive the main path over HTTP; returns the LegalEngine and the
    launch counts over exactly that run (``kernel`` must have launched
    at least once per device search). A quantized tier's server must
    refuse maxsim-rerank with a 422."""
    import torch

    from legal_rag_tpu_torch.cli import BackgroundServer
    from legal_rag_tpu_torch.index.synthetic import planted_ids
    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    kw = {} if config is None else {"config": config}
    legal = LegalEngine(store=store, use_llm=False, device=device, **kw)
    engine = legal.engine
    engine.enable_request_coalescing()
    ce = legal.orchestrator.reranker
    check(ce is not None, "cross-encoder not enabled")
    ce_calls = []
    ce_score_pairs = ce.score_pairs

    def counted_score_pairs(*a, **kw):
        ce_calls.append(1)
        return ce_score_pairs(*a, **kw)

    ce.score_pairs = counted_score_pairs
    server = BackgroundServer(legal)
    try:
        reset_counts()
        engine.device_dispatches = 0
        t0 = time.time()
        answers = [post(f"{server.url}/api/v1/query", {"query": q})
                   for q in PRIMARY]
        batch = post(f"{server.url}/api/v1/batch_search",
                     {"queries": list(PRIMARY), "k": 5})
        if device == "cuda":
            torch.cuda.synchronize()
        counts, dispatches = read_counts(), engine.device_dispatches
        n_ce = len(ce_calls)
        wall = time.time() - t0
        with urllib.request.urlopen(f"{server.url}/health", timeout=60) as r:
            health = json.loads(r.read())
        served = {}
        if kernel == "K1":
            # a client's batch of 64 (one device search at Q=64) and of 68
            # (padded to Q=128)
            for n, queries in SERVED_BATCHES.items():
                reset_counts()
                rows = post(f"{server.url}/api/v1/batch_search",
                            {"queries": list(queries), "k": 10})["results"]
                if device == "cuda":
                    torch.cuda.synchronize()
                served[n] = (rows, read_counts())
        refused = None
        if engine.config.dense.dtype not in ("float32", "bfloat16"):
            refused = post_status(f"{server.url}/api/v1/batch_search",
                                  {"queries": [HEADING],
                                   "fusion_mode": "maxsim-rerank"})
    finally:
        server.stop()
    if refused is not None:
        check(refused[0] == 422, f"maxsim-rerank on the {tier_name(engine)} "
              f"tier answered {refused}, not 422")
    plant = planted_ids(n_docs, len(PRIMARY))
    for j, body in enumerate(answers):
        for key in ("answer", "sources", "context_used", "adapted", "disclaimer"):
            check(key in body, f"query {j}: payload lacks {key!r}")
        cites = [c["citation"] for c in body["context_used"]]
        check(f"PLANTED {j}" in cites, f"query {j}: planted doc not in {cites}")
    check(answers[0]["metadata"]["user_context"] == "victim_distress", "victim")
    for j, rows in enumerate(batch["results"]):
        check(bool(rows) and rows[0]["doc_id"] == plant[j],
              f"batch query {j}: planted doc {plant[j]} not first")
    check(dispatches >= 5, f"only {dispatches} device searches")
    check(n_ce == len(PRIMARY), f"cross-encoder ran {n_ce}x")
    reranked = legal.orchestrator.orchestrate(HEADING)["results"]
    check(all(math.isfinite(r["rerank_score"]) for r in reranked), "CE scores")
    stages = health["stage_latency"]
    check(health["engine_status"] == "ready" and "device_search" in stages,
          "health")
    tier = tier_name(engine)
    print(f"phase {phase} ok: {tier} engine: 3 /api/v1/query + 1 "
          f"/api/v1/batch_search answered 200 in {wall:.2f} s with planted "
          f"docs found; {dispatches} device searches, {kernel} launched "
          f"{counts[kernel]}x; cross-encoder scored "
          f"{n_ce} pools (rerank_score present); mean stage ms: "
          + ", ".join(f"{k} {v['mean_ms']:.2f}" for k, v in stages.items())
          + ("" if refused is None else
             "; maxsim-rerank refused with 422 (quantized tier)"),
          flush=True)
    if device == "cuda":
        check(counts[kernel] >= dispatches, f"{kernel} launched "
              f"{counts[kernel]} times for {dispatches} device searches")
    for n, (rows, counts_n) in served.items():
        check(len(rows) == n and all(len(r) == 10 for r in rows),
              f"batch of {n}")
        if device == "cuda":
            check(counts_n["K1 tensor cores"] >= 1, f"the {n}-query batch "
                  f"never reached K1's tensor-core kernel: {counts_n}")
        print(f"phase {phase} ok: POST /api/v1/batch_search of {n} queries "
              f"(k=10, run at Q={_pad_pow2(n)}) answered 200 with 10 rows "
              f"each; K1 launched {counts_n['K1']}x "
              f"({counts_n['K1 tensor cores']}x on the tensor cores)",
              flush=True)
    return legal, counts, served


def tier_name(engine) -> str:
    return engine.config.dense.dtype + (
        " + IVF" if engine.index.ivf_centroids is not None else "")


def phase_compare(store, engine, expansions, served=None):
    from legal_rag_tpu_torch.ops.dense import LARGE_N_THRESHOLD
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    cpu = RetrievalEngine(store, device="cpu")
    cfg = cpu.config
    scatter = engine.index.docs.shape[0] <= LARGE_N_THRESHOLD
    victim_batch = [VICTIM] + list(expansions)
    victim_w = [0.6 if "procedure" in q.lower() else 0.5 for q in victim_batch]
    calls = [
        (victim_batch, 16, victim_w, "rrf"),
        ([VICTIM], 16, [0.0], "weighted"),
        ([PROCEDURAL], 16, [0.6], "rrf"),
        ([HEADING], 16, [0.5], "rrf"),
        (list(PRIMARY), 5, [0.5] * 3, "rrf"),
        (list(PRIMARY), 5, [0.5] * 3, "weighted"),
    ]
    swaps = 0
    for queries, k, w, mode in calls:
        dev_rows = engine.search_batch(queries, k=k, hybrid_weights=w, mode=mode)
        cpu_rows = cpu.search_batch(queries, k=k, hybrid_weights=w, mode=mode)
        channels = channel_scores(store, cpu.encoder, queries,
                                  cfg.bm25.postings_budget_cap, scatter)
        swaps += assert_equal_under_ties(
            dev_rows, cpu_rows, channels, mode, w,
            cfg.fusion.candidate_multiplier * k, cfg.fusion.rrf_k,
            f"{mode} {queries[0][:24]!r}")
    for n, (batch, _) in (served or {}).items():
        # a served batch (HTTP rows) against the CPU engine under the
        # same call, default weights and mode
        from types import SimpleNamespace

        check(cfg.fusion.mode == "rrf", "default fusion mode")
        want = cpu.search_batch(list(SERVED_BATCHES[n]), k=10)
        got = [[SimpleNamespace(doc_id=r["doc_id"], score=r["score"])
                for r in rows] for rows in batch]
        swaps += assert_rows_close(got, want, "rrf", None,
                                   f"served batch of {n}")
        calls.append((SERVED_BATCHES[n], 10, None, "rrf"))
    print(f"phase 5 ok: {len(calls)} search_batch calls on the card equal "
          f"the CPU engine's under the tie-aware rule (fused scores within "
          f"tolerance rank by rank; every doc placed as its exact dense "
          f"and BM25 scores allow, dense tol {DENSE_TOL}, BM25 tol 4e-6 x "
          f"prefix sum; {swaps} ranks hold tied docs in another order)",
          flush=True)


TIER_CALLS = (
    (list(PRIMARY), 16, [0.0] * 3, "weighted"),
    (list(PRIMARY), 5, [0.5] * 3, "weighted"),
    (list(PRIMARY), 5, [0.5] * 3, "rrf"),
    ([HEADING], 16, [0.5], "weighted"),
    ([PROCEDURAL], 16, [0.6], "rrf"),
)


def phase_tiers(store, n_docs: int, device: str = "cuda"):
    """The int8 and the flat PQ engines on the card through search_batch
    (planted docs first); returns the engines and the launch counts."""
    import torch

    from legal_rag_tpu_torch.index.synthetic import planted_ids
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    plant = planted_ids(n_docs, len(PRIMARY))
    engines, counts = {}, {}
    for name, cfg, kernel in (
        ("int8", tier_config("int8"), "K1-int8"),
        ("pq", tier_config("pq", use_ivf=False, pq_oversample=64), "K2"),
    ):
        engine = RetrievalEngine(store, config=cfg, device=device)
        check(engine.index.ivf_centroids is None, f"{name}: unexpected IVF")
        reset_counts()
        engine.device_dispatches = 0
        for queries, k, w, mode in TIER_CALLS:
            rows = engine.search_batch(queries, k=k, hybrid_weights=w,
                                       mode=mode)
            for q, row in zip(queries, rows):
                j = PRIMARY.index(q)
                check(bool(row) and row[0].doc_id == plant[j],
                      f"{name} {mode}: planted doc {plant[j]} not first for "
                      f"{q[:24]!r}: {[r.doc_id for r in row]}")
        if device == "cuda":
            torch.cuda.synchronize()
        counts[name] = read_counts()
        n = counts[name][kernel]
        check(device != "cuda" or n >= engine.device_dispatches > 0,
              f"{name}: {kernel} launched {n}x for "
              f"{engine.device_dispatches} device searches")
        engines[name] = engine
    print(f"phase 6b ok: int8 and flat PQ engines, {len(TIER_CALLS)} "
          f"search_batch calls each with planted docs first; K1-int8 "
          f"launched {counts['int8']['K1-int8']}x, K2 "
          f"{counts['pq']['K2']}x", flush=True)
    return engines, counts


def assert_rows_close(dev_rows, cpu_rows, mode, tols, what):
    """Two engines' rows: fused scores equal rank by rank within the
    query's tolerance (RRF: within one place's worth, ``RRF_SWAP``, for
    docs a near-tie let trade places in one channel); where ids differ,
    the other side holds the doc at a rank of equal score, or both
    split a tie at the end of the list. Returns the ranks that differ."""
    swaps = 0
    for qi, (g, h) in enumerate(zip(dev_rows, cpu_rows)):
        check(len(g) == len(h), f"{what}: query {qi}: result counts differ")
        tol = tols[qi] if mode == "weighted" else RRF_SWAP + 1e-6
        got = [(r.doc_id, r.score) for r in g]
        want = [(r.doc_id, r.score) for r in h]
        for rank, ((a, fa), (b, fb)) in enumerate(zip(got, want)):
            check(abs(fa - fb) <= tol, f"{what}: query {qi} rank {rank}: "
                  f"{got} vs {want}")
            if a != b:
                swaps += 1
                other = {d: f for d, f in want}
                check((a in other and abs(other[a] - fa) <= tol)
                      or fa <= want[-1][1] + tol,
                      f"{what}: query {qi} rank {rank}: {got} vs {want}")
    return swaps


def phase_compare_tiers(store, tier_engines, ivf_engine, fp32_engine,
                        expansions):
    """Each quantized tier on the card against the same tier on the
    CPU, and the int8 engine's weighted results against fp32's."""
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    checked, swaps = 0, 0
    cpu_cfg = {"int8": tier_config("int8"),
               "pq": tier_config("pq", use_ivf=False, pq_oversample=64),
               "pq+ivf": pq_ivf_config()}
    card = dict(tier_engines, **{"pq+ivf": ivf_engine})
    calls = list(TIER_CALLS)
    for name, engine in card.items():
        cpu = RetrievalEngine(store, config=cpu_cfg[name], device="cpu")
        cfg = cpu.config
        for queries, k, w, mode in calls:
            dev_rows = engine.search_batch(queries, k=k, hybrid_weights=w,
                                           mode=mode)
            cpu_rows = cpu.search_batch(queries, k=k, hybrid_weights=w,
                                        mode=mode)
            channels = channel_scores(store, cpu.encoder, queries,
                                      cfg.bm25.postings_budget_cap, False)
            tols = [fused_tol(ch, mode, wi) for ch, wi in zip(channels, w)]
            swaps += assert_rows_close(dev_rows, cpu_rows, mode, tols,
                                       f"{name} {mode} {queries[0][:24]!r}")
            if name == "int8" and mode == "weighted" and not any(w):
                # with the fp32 rescore int8 gives fp32's results when
                # the oversampled candidates cover fp32's dense pool:
                # assured for dense-only fusion; with a BM25 weight the
                # device fuses before the rescore narrows the pool, so
                # the pools may differ (in the JAX engine as well)
                want = fp32_engine.search_batch(queries, k=k,
                                                hybrid_weights=w, mode=mode)
                swaps += assert_rows_close(dev_rows, want, mode, tols,
                                           f"int8 vs fp32 {queries[0][:24]!r}")
                check([[r.doc_id for r in row] for row in dev_rows]
                      == [[r.doc_id for r in row] for row in want],
                      "int8 weighted ids != fp32 ids")
            checked += 1
        del cpu
    print(f"phase 7 ok: {checked} search_batch calls over the int8, flat PQ "
          f"and PQ + IVF tiers on the card equal the CPU engines' under the "
          f"tie-aware rule ({swaps} ranks hold tied docs in another order); "
          f"int8 weighted (dense-only) ids equal the fp32 engine's",
          flush=True)


def maxsim64(torch, q_tok, q_mask, mv, n_docs: int, block: int = 8192):
    """float64 MaxSim ``[Q, n_docs]`` of bf16 query tokens over the
    index's slab, blockwise on its device."""
    qt = q_tok.to(torch.bfloat16).double()
    real = (torch.as_tensor(q_mask, device=qt.device) > 0).double()
    out = torch.empty((qt.shape[0], n_docs), dtype=torch.float64,
                      device=qt.device)
    for lo in range(0, n_docs, block):
        hi = min(lo + block, n_docs)
        sims = torch.einsum("qtd,bsd->qtbs", qt, mv.doc_tokens[lo:hi].double())
        sims.masked_fill_(mv.doc_mask[lo:hi][None, None] <= 0, -math.inf)
        best = sims.amax(dim=3)
        best = torch.where(torch.isfinite(best), best, 0.0)
        out[:, lo:hi] = (best * real[:, :, None]).sum(dim=1)
    return out


def phase_maxsim(store, legal, n_docs: int, device: str = "cuda"):
    """The late-interaction modes behind the HTTP server on the fp32
    engine: ``batch_search`` of the three PRIMARY queries (k=10) in
    maxsim-rerank and maxsim mode, planted docs first; the full scan
    equal to a float64 MaxSim brute force over the same bf16 slab, the
    rerank equal to exact MaxSim over the dense stage's own top-C, K1
    launched on every maxsim-rerank device search. Returns the launch
    counts of the maxsim-rerank run and the phase's numbers."""
    import torch

    from legal_rag_tpu_torch.cli import BackgroundServer
    from legal_rag_tpu_torch.index.synthetic import planted_ids
    from legal_rag_tpu_torch.ops.maxsim import scan_block_n
    from legal_rag_tpu_torch.parallel.sharded import _local_dense_topc
    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2
    from legal_rag_tpu_torch.utils.timing import time_ms

    t0 = time.time()
    engine = legal.engine
    mv = engine.mv_index
    if device == "cuda":
        torch.cuda.synchronize()
    t_upload = time.time() - t0
    check(mv.doc_tokens.shape[0] == engine.index.docs.shape[0],
          "slab and dense matrix padded differently")
    k, queries = 10, list(PRIMARY)
    server = BackgroundServer(legal)
    rows, counts, stages = {}, {}, {}
    try:
        for mode in ("maxsim-rerank", "maxsim"):
            payload = {"queries": queries, "k": k, "fusion_mode": mode}
            post(f"{server.url}/api/v1/batch_search", payload)   # warm-up
            engine.timer.reset()
            reset_counts()
            engine.device_dispatches = 0
            for _ in range(MAXSIM_REPS):
                rows[mode] = post(f"{server.url}/api/v1/batch_search",
                                  payload)["results"]
            if device == "cuda":
                torch.cuda.synchronize()
            counts[mode] = (read_counts(), engine.device_dispatches)
            stages[mode] = engine.timer.snapshot()
    finally:
        server.stop()
    plant = planted_ids(n_docs, len(PRIMARY))
    for mode, got in rows.items():
        for j, row in enumerate(got):
            check(len(row) == k and row[0]["doc_id"] == plant[j],
                  f"{mode}: planted doc {plant[j]} not first for query {j}: "
                  f"{[r['doc_id'] for r in row]}")
    rerank_counts, dispatches = counts["maxsim-rerank"]
    check(dispatches == MAXSIM_REPS, f"{dispatches} maxsim-rerank searches")
    if device == "cuda":
        check(rerank_counts["K1"] >= dispatches, f"K1 launched "
              f"{rerank_counts['K1']}x for {dispatches} maxsim-rerank "
              f"device searches")

    # the references, from the engine's own query encoding
    padded = queries + [""] * (_pad_pow2(len(queries)) - len(queries))
    q_tok, q_mask, q_emb = engine._encode_query_tokens(padded)
    nq = len(queries)
    s64 = maxsim64(torch, q_tok[:nq], q_mask[:nq], mv, n_docs)
    c = max(engine.config.fusion.candidate_multiplier * k, k)
    _, cand = _local_dense_topc(q_emb, engine.index.docs, n_docs, c)
    pool = torch.full_like(s64, -math.inf)
    for qi in range(nq):
        ids = cand[qi][(cand[qi] >= 0) & (cand[qi] < n_docs)]
        pool[qi, ids] = s64[qi, ids]
    for mode, want in (("maxsim", s64), ("maxsim-rerank", pool)):
        for qi, row in enumerate(rows[mode]):
            tol = MAXSIM_TOL * float(q_mask[qi].sum())
            assert_topk_equiv_scores(
                torch, want[qi:qi + 1], k,
                torch.tensor([[r["score"] for r in row]], device=s64.device),
                torch.tensor([[r["doc_id"] for r in row]], device=s64.device),
                tol=tol)
    # the engine's scan alone, at its block and at the JAX default 512
    block = scan_block_n(*q_mask.shape, mv.doc_tokens.shape[1])
    scan = {}
    if device == "cuda":
        for b in (block, 512):
            scan[b] = time_ms(lambda: mv.search(q_tok, q_mask, k, block_n=b),
                              iters=3, warmup=1)
        profile = device_breakdown(
            torch, lambda: mv.search(q_tok, q_mask, k, block_n=block))
    slab_gb = mv.doc_tokens.numel() * mv.doc_tokens.element_size() / 1e9
    return {
        "counts": rerank_counts, "stages": stages, "slab_gb": slab_gb,
        "block": block, "scan_ms": scan, "upload_s": t_upload,
        "profile": profile if device == "cuda" else None,
        "wall_s": time.time() - t0, "q": len(padded),
        "tq": int(q_tok.shape[1]),
    }


def device_breakdown(torch, fn, top: int = 4):
    """One call of ``fn`` under torch.profiler: ``(wall ms, device busy
    ms, the ``top`` kernels by device ms)``; busy is None where the
    profiler records no device time. Both are read with the profiler
    on, which adds host cost to every launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels.append((ev.key[:48], us / 1e3))
    if not kernels:
        return wall, None, []
    kernels.sort(key=lambda kv: -kv[1])
    return wall, sum(ms for _, ms in kernels), kernels[:top]


def phase_gather(store, expansions, device: str = "cuda", reps: int = 3):
    """The device postings gather on phase 3's postings (resident on the
    device) against the host gather: equal, as postings multisets, for
    every query at the uncapped budget (none overflows there); then both
    timed at the engine's capped budget, in turns (host, device, device,
    host), host clock ending in a synchronize, each including the move
    of its batch to the device. Returns ``(ms by side, the capped and
    the uncapped budget, queries)``."""
    import torch

    from legal_rag_tpu_torch.config import BM25Config
    from legal_rag_tpu_torch.ops.sparse import bm25_gather_postings_device
    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2

    bm = store.bm25
    queries = list(PRIMARY) + list(expansions)
    queries += [""] * (_pad_pow2(len(queries)) - len(queries))
    full = _pad_pow2(bm.postings_budget(queries))
    capped = _pad_pow2(bm.postings_budget(
        queries, cap=BM25Config.postings_budget_cap))
    post_ids = torch.from_numpy(bm.doc_ids).to(device)
    post_w = torch.from_numpy(bm.weights).to(device)

    def host(budget):
        ids, w = bm.gather_postings(queries, budget)
        return torch.from_numpy(ids).to(device), torch.from_numpy(w).to(device)

    def dev(budget):
        meta = (torch.from_numpy(m).to(device)
                for m in bm.query_term_meta(queries))
        return bm25_gather_postings_device(*meta, post_ids, post_w, budget)

    h_ids, h_w = (x.cpu().numpy() for x in host(full))
    d_ids, d_w = (x.cpu().numpy() for x in dev(full))
    check(bool((bm.query_term_meta(queries)[1].sum(axis=1) <= full).all()),
          "the uncapped budget overflows")
    for qi, q in enumerate(queries):
        keep_h, keep_d = h_ids[qi] < bm.n_docs, d_ids[qi] >= 0
        check(sorted(zip(h_ids[qi][keep_h].tolist(), h_w[qi][keep_h].tolist()))
              == sorted(zip(d_ids[qi][keep_d].tolist(),
                            d_w[qi][keep_d].tolist())),
              f"device gather != host gather for {q[:24]!r}")
    times = {}
    for name, fn in (("host", host), ("device", dev), ("device", dev),
                     ("host", host)):
        fn(capped)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(capped)
            if device == "cuda":
                torch.cuda.synchronize()
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) / reps * 1e3)
    return times, capped, full, len(queries)


BUILD_CHUNKS = 2620  # the serving corpus's chunk count
BUILD_ARGS = ("--finetune-steps", "300", "--finetune-token-weight", "0.5",
              "--pq-m", "48", "--ivf-cell-size", "256", "--rerank-steps",
              "300", "--multi-vector", "32")     # flag, value pairs
BUILD_SUBSET = 256      # chunks of the untrained card-vs-CPU build
ENCODE_DOCS = 65_536    # the encode throughput's corpus
ENCODE_BATCHES = (64, 512)
EMB_TOL = 1e-5          # card vs CPU embeddings: fp32 sums in another order


def minilm_flops(cfg, lengths, train: bool = False) -> float:
    """Matmul FLOPs of MiniLM forwards over sequences of ``lengths``
    tokens: per layer 8 L H^2 (projections) + 4 L H I (feed-forward) +
    4 L^2 H (scores and context); a training step adds the backward's
    two products per forward product."""
    h, i = cfg.hidden, cfg.intermediate
    total = sum(8 * n * h * h + 4 * n * h * i + 4 * n * n * h
                for n in lengths) * cfg.layers
    return 3.0 * total if train else float(total)


def _run_cli(argv) -> str:
    """``legal_rag_tpu_torch.cli.main(argv)`` in this process; returns
    what it printed."""
    import contextlib
    import io

    from legal_rag_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    check(rc == 0, f"{argv[0]} exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def _losses(log: str, prefix: str) -> dict:
    import re

    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        rf"^{prefix} (\d+): loss ([0-9.]+)$", log, re.M)}


def _serve_and_ask(store_dir: str, titles, device: str):
    """``python -m legal_rag_tpu_torch serve`` over the built store, in a
    process of its own: POST /api/v1/query per title and one
    /api/v1/batch_search of them all (k=10); the server is stopped
    before this returns. Returns (answers, batch rows, seconds to ready)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if "API_KEY" not in k}
    log = open(os.path.join(REPO_ROOT, "build", "smoke_serve.log"), "w")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "legal_rag_tpu_torch", "serve", "--store",
         store_dir, "--host", "127.0.0.1", "--port", str(port), "--device",
         device],
        cwd=REPO_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        while True:
            check(proc.poll() is None, f"serve exited {proc.returncode}; "
                  "see build/smoke_serve.log")
            check(time.time() - t0 < 300, "serve not ready in 300 s")
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if json.loads(r.read()).get("engine_status") == "ready":
                        break
            except OSError:
                pass
            time.sleep(1)
        ready_s = time.time() - t0
        answers = [post(url + "/api/v1/query", {"query": q}) for q in titles]
        batch = post(url + "/api/v1/batch_search",
                     {"queries": list(titles), "k": 10})["results"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    return answers, batch, ready_s


def phase_build(seed: int, device: str = "cuda", n_chunks: int = BUILD_CHUNKS,
                build_args=BUILD_ARGS, subset: int = BUILD_SUBSET,
                encode_docs: int = ENCODE_DOCS, timed_steps: int = 10) -> dict:
    """The build path on ``device``: a markdown corpus of the five laws,
    ``ingest`` and ``build`` through the port's command line, the store
    served by ``python -m legal_rag_tpu_torch serve`` and asked each of
    three titles (its own chunks must come back in the top 10), an
    untrained build of ``subset`` chunks against the CPU's, the encode
    throughput over ``encode_docs`` chunks of the corpus's lengths, and
    the training steps' times. Returns what the phase line prints."""
    import shutil

    import numpy as np
    import torch

    from legal_rag_tpu_torch.evaluation import labeled_pairs_from_chunks
    from legal_rag_tpu_torch.index.builder import build_index
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    out = {"build_args": build_args, "subset": subset,
           "encode_docs": encode_docs}
    root = os.path.join(REPO_ROOT, "build", "smoke_build")
    shutil.rmtree(root, ignore_errors=True)
    docs, chunks_json = os.path.join(root, "docs"), os.path.join(root,
                                                                "chunks.json")
    store_dir = os.path.join(root, "store")
    t0 = time.time()
    write_legal_corpus(docs, n_chunks=n_chunks, seed=seed)
    ingest_log = _run_cli(["ingest", "--docs", docs, "--out", chunks_json,
                           "--debug-dump", ""])
    out["ingest"] = ingest_log.strip().splitlines()[0]
    out["corpus_s"] = time.time() - t0
    t0 = time.time()
    log = _run_cli(["build", "--source", chunks_json, "--store", store_dir,
                    "--device", device, *build_args])
    out["build_s"] = time.time() - t0
    with open(os.path.join(root, "build.log"), "w") as f:
        f.write(log)
    ft, ce = _losses(log, "step"), _losses(log, "ce-hard step")
    check(ft and all(map(math.isfinite, ft.values())), "fine-tune losses")
    check(ce and all(map(math.isfinite, ce.values())), "CE losses")
    # the fine-tune's logged losses fall from the first third to the last
    # (one batch's loss is noisy); the CE's recipe sits near chance, ln 8,
    # for its first few hundred steps in both packages, so its losses are
    # printed and the gate decides
    third = max(1, len(ft) // 3)
    logged = [ft[k] for k in sorted(ft)]
    check(len(logged) < 2 or sum(logged[-third:]) < sum(logged[:third]),
          f"fine-tune loss did not fall: {ft}")
    out["ft_losses"], out["ce_losses"] = ft, ce
    out["gate"] = [ln.strip() for ln in log.splitlines()
                   if "gate alpha" in ln or "reranker " in ln]
    out["stages"] = next(ln for ln in log.splitlines()
                         if ln.startswith("build stages (s): "))
    store = VectorStore.load(store_dir)
    chunks = store.chunks
    check(store.n_docs == len(chunks) and np.isfinite(store.embeddings).all(),
          "store")
    flags = {k: int(float(v)) for k, v in zip(build_args[::2],
                                               build_args[1::2])}
    check(store.pq_codes.shape == (store.n_docs, flags["--pq-m"]), "PQ codes")
    check(store.ivf_centroids.shape[0] == -(-store.n_docs // flags[
        "--ivf-cell-size"]), "IVF cells")
    check(store.mv_tokens.shape[1:] == (flags["--multi-vector"], store.dim),
          "token slab")
    out["validated"] = store.ce_params is not None
    out["alpha"] = store.ce_alpha
    check(out["validated"] == any("reranker validated" in g
                                  for g in out["gate"]), "gate verdict")
    out["n_docs"] = store.n_docs

    # serve the built store in a process of its own, ask three titles
    pairs = labeled_pairs_from_chunks(chunks)
    asked = [pairs[0], pairs[len(pairs) // 2], pairs[-1]]
    answers, batch, out["ready_s"] = _serve_and_ask(
        store_dir, [q for q, _ in asked], device)
    for (title, rel), body, rows in zip(asked, answers, batch):
        sids = {chunks[i].get("section_id") for i in rel} - {None}
        got = {c.get("section_id") for c in body["context_used"]}
        check(bool(sids & got), f"/api/v1/query {title!r}: none of {sids} "
              f"in {got}")
        ids = [r["doc_id"] for r in rows]
        check(len(ids) == 10 and set(rel) & set(ids), f"batch_search "
              f"{title!r}: none of {rel} in the top 10 {ids}")
    out["asked"] = [q for q, _ in asked]

    # an untrained build of a subset on the card against the CPU's
    sub = chunks[:subset]
    t0 = time.time()
    card = build_index(sub, device=device)
    out["subset_card_s"] = time.time() - t0
    t0 = time.time()
    cpu = build_index(sub, device="cpu")
    out["subset_cpu_s"] = time.time() - t0
    err = float(np.abs(card.embeddings - cpu.embeddings).max())
    check(err <= EMB_TOL, f"card vs CPU embeddings {err}")
    check(card.corpus_hash == cpu.corpus_hash, "card vs CPU corpus_hash")
    for field in ("indptr", "doc_ids", "weights", "idf", "doc_len"):
        check(np.array_equal(getattr(card.bm25, field),
                             getattr(cpu.bm25, field)), f"BM25 {field}")
    out["subset_err"] = err
    del card, cpu

    out.update(measure_build_steps(store, chunks, device, encode_docs,
                                   timed_steps))
    return out


def measure_build_steps(store, chunks, device, encode_docs, timed_steps):
    """Encode throughput (the corpus's token ids tiled to
    ``encode_docs``, device batches of each ENCODE_BATCHES size; the
    tokenizer's host rate apart) beside the fp32 FLOP bound, and the
    ms of one fine-tune step (batch 32, max_len 128, with and without
    the token term) and one CE step (8 groups of 8 docs), by CUDA
    events over ``timed_steps`` steps on fixed batches."""
    import copy

    import numpy as np
    import torch

    from legal_rag_tpu_torch.models.cross_encoder import (
        CrossEncoder, _fixed_pairs, make_ce_train_step_grouped,
    )
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.finetune import (
        fixed_length, make_sibling_pairs,
    )
    from legal_rag_tpu_torch.models.train import adamw, make_train_step
    from legal_rag_tpu_torch.models.wordpiece import (
        WordPieceTokenizer, pad_and_bucket,
    )
    from legal_rag_tpu_torch.utils.timing import time_ms

    fp32 = PEAK_OPS_PER_S["fp32"]
    out = {}
    enc = SentenceEncoder(params=store.encoder_params,
                          tokenizer=WordPieceTokenizer(store.wp_vocab),
                          device=device)
    texts = [c["text"] for c in chunks]
    t0 = time.time()
    ids = enc.tokenize(texts)
    out["tokenize_docs_s"] = len(texts) / (time.time() - t0)
    tiled = [ids[i % len(ids)] for i in range(encode_docs)]
    lengths = sorted(len(t) for t in tiled)
    out["encode"] = {}
    for bs in ENCODE_BATCHES:
        padded = []
        for lo in range(0, len(lengths), bs):
            part = lengths[lo:lo + bs]
            padded += [pad_and_bucket([np.zeros(part[-1], np.int32)],
                                      enc.cfg.max_len, 0)[0].shape[1]] * len(
                part)
        enc.encode_ids(tiled[:bs * 2], batch_size=bs)      # warm-up
        t0 = time.time()
        emb = enc.encode_ids(tiled, batch_size=bs)
        dt = time.time() - t0
        check(emb.shape == (encode_docs, enc.cfg.hidden)
              and np.isfinite(emb).all(), "encode output")
        flops = minilm_flops(enc.cfg, padded)
        out["encode"][bs] = {
            "docs_s": encode_docs / dt, "s": dt, "tflops": flops / dt / 1e12,
            "bound_docs_s": encode_docs / (flops / fp32),
            "bound_real_docs_s": encode_docs / (
                minilm_flops(enc.cfg, lengths) / fp32),
        }
    out["mean_tokens"] = float(np.mean(lengths))
    # what keeping TF32 off costs: the batch-512 encode with it on
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t0 = time.time()
        tf32 = enc.encode_ids(tiled, batch_size=ENCODE_BATCHES[-1])
        out["encode_tf32_docs_s"] = encode_docs / (time.time() - t0)
        out["tf32_err"] = float(np.abs(tf32 - emb).max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    # one fine-tune batch and one CE batch, fixed, on the card
    rng = np.random.default_rng(0)
    stream = make_sibling_pairs(chunks, rng)
    queries, docs = zip(*(next(stream) for _ in range(32)))
    max_len = min(enc.cfg.max_len, 128)
    tok, pad = enc.tokenizer, enc.tokenizer.pad_id
    q_ids, q_mask = tok.encode_batch(queries, max_len=max_len)
    d_ids, d_mask = tok.encode_batch(docs, max_len=max_len)
    batch = (fixed_length(q_ids, 32, max_len, pad, device),
             fixed_length(q_mask, 32, max_len, 0, device),
             fixed_length(d_ids, 32, max_len, pad, device),
             fixed_length(d_mask, 32, max_len, 0, device))
    step_flops = minilm_flops(enc.cfg, [max_len] * 64, train=True)
    out["steps"] = {}
    for weight in (0.0, 0.5):
        model = copy.deepcopy(enc.model)
        step = make_train_step(model, adamw(model.parameters(), 2e-5),
                               maxsim_weight=weight)
        ms = time_ms(lambda: step(*batch), iters=timed_steps, warmup=2)
        out["steps"][f"finetune tok={weight}"] = (ms, step_flops / fp32 * 1e3)
        if weight:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                out["steps"]["finetune tok=0.5, TF32 on"] = (time_ms(
                    lambda: step(*batch), iters=timed_steps, warmup=2),
                    step_flops / PEAK_OPS_PER_S["tf32"] * 1e3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        del model, step
    ce = CrossEncoder(enc)
    grid_q = [q for q in queries[:8] for _ in range(8)]
    grid_d = list(docs[:8]) * 8
    pairs = _fixed_pairs(ce, grid_q, grid_d, max_len)
    step = make_ce_train_step_grouped(ce, adamw(ce.parameters(), 5e-5), 8)
    ms = time_ms(lambda: step(*pairs), iters=timed_steps, warmup=2)
    out["steps"]["CE 8x8"] = (ms, step_flops / fp32 * 1e3)
    del ce, step
    torch.cuda.empty_cache()
    return out


def print_build(b: dict) -> None:
    """Phase 9's two lines, from what ``phase_build`` returns."""
    print(f"phase 9 ok: {b['ingest']} ({b['corpus_s']:.1f} s); build "
          f"{' '.join(b['build_args'])} of {b['n_docs']} chunks in "
          f"{b['build_s']:.1f} s; {b['stages']}; fine-tune loss by step "
          + ", ".join(f"{k} {v:.4f}" for k, v in b["ft_losses"].items())
          + "; CE loss by step "
          + ", ".join(f"{k} {v:.4f}" for k, v in b["ce_losses"].items())
          + f"; gate: {' | '.join(b['gate'])} (persisted: {b['validated']}, "
          f"alpha {b['alpha']}); `serve` ready in {b['ready_s']:.1f} s, "
          f"/api/v1/query and batch_search (k=10) found each title's own "
          f"chunks for {b['asked']}; untrained {b['subset']}-chunk build on "
          f"the card ({b['subset_card_s']:.1f} s) == the CPU's "
          f"({b['subset_cpu_s']:.1f} s): embeddings within {EMB_TOL} (max "
          f"abs err {b['subset_err']:.3g}), BM25 equal, corpus_hash equal",
          flush=True)
    print(f"phase 9 ok: tokenizer (host, Python) "
          f"{b['tokenize_docs_s']:.0f} docs/s; encode of {b['encode_docs']} "
          f"chunks "
          f"(mean {b['mean_tokens']:.1f} WordPiece tokens, fp32, TF32 off): "
          + "; ".join(
              f"batch {bs}: {e['docs_s']:.0f} docs/s ({e['s']:.3f} s, "
              f"{e['tflops']:.2f} TFLOP/s; fp32 FLOP bound "
              f"{e['bound_docs_s']:.0f} docs/s at the padded lengths, "
              f"{e['bound_real_docs_s']:.0f} at the real ones)"
              for bs, e in b["encode"].items())
          + f"; with TF32 on, batch {ENCODE_BATCHES[-1]}: "
          f"{b['encode_tf32_docs_s']:.0f} docs/s (max abs change of an "
          f"embedding {b['tf32_err']:.3g})"
          + "; ms a step (CUDA events, fixed batches, FLOP bound of its "
          "type beside): " + "; ".join(
              f"{name} {ms:.3f} (bound {bnd:.3f})"
              for name, (ms, bnd) in b["steps"].items()), flush=True)


def ptxas_registers(log: str) -> str:
    """``kernel<template args>: N`` for every instantiation in an nvcc
    ``-Xptxas -v`` log."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", ln)
        if m:
            # a mangled name is <length><identifier>...: find the
            # identifier ending in _kernel, then its template arguments
            mangled, name = m.group(1), "?"
            k = re.search(r"_kernel(?=[IE])", mangled)
            end = k.end() if k else 0
            for size in range(len("_kernel"), end):
                if mangled[:end - size].endswith(str(size)):
                    args = re.match(r"I(\w*?)E+v", mangled[end:])
                    args = args.group(1) if args else ""
                    args = re.sub(r"^f", "f32,", args)
                    args = args.replace("13__nv_bfloat16", "bf16,")
                    args = re.sub(r"Li(\d+)E?", r"\1,", args).strip(",")
                    name = mangled[end - size:end] + (f"<{args}>" if args
                                                      else "")
                    break
        elif name and "Used " in ln:
            out.append(f"{name}: {ln.split('Used ')[1].split(' registers')[0]}")
            name = None
    return ", ".join(out)


def build_kernels() -> dict:
    """Build every kernel at once (one nvcc each); returns, per kernel,
    its source, build seconds and ptxas registers per instantiation."""
    from concurrent.futures import ThreadPoolExecutor

    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.mm_rowmax import X2
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1
    from legal_rag_tpu_torch.ops.stream_probe import X1

    def build(kernel):
        t0 = time.time()
        kernel.library()
        return time.time() - t0

    kernels = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "P": P, "X1": X1,
               "X2": X2}
    with ThreadPoolExecutor(len(kernels)) as pool:
        secs = {n: pool.submit(build, k) for n, k in kernels.items()}
        secs = {n: f.result() for n, f in secs.items()}
    return {n: (k.source, secs[n], ptxas_registers(k.build_log))
            for n, k in kernels.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO_ROOT)

    t_start = time.time()
    kind = torch.cuda.get_device_name(0)

    # -- 1. card and kernel build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the plain versions' fp32 products in true fp32, as RetrievalEngine sets
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_kernels()
    probe = phase_probe(torch)
    print(f"phase 1 ok: {kind}, torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); " + "; ".join(
              f"{name} built from legal_rag_tpu_torch/csrc/{src} in "
              f"{secs:.2f} s (ptxas registers: {regs})"
              for name, (src, secs, regs) in built.items())
          + f"; P on its [8, 256] tie input (ones at 33 and 200) gave "
          f"{probe['rows']} == plain, launched {probe['launches']}x, "
          f"{probe['ms']:.4f} ms (plain {probe['plain_ms']:.4f} ms, "
          f"torch.argmax {probe['library_ms']:.4f} ms)", flush=True)
    steps = probe["steps"]
    device_us = steps.pop("device_us")
    print("phase 1 ok: P's host steps, ns a call over 10,000 calls: "
          + ", ".join(f"{name} {ns:.1f}" for name, ns in steps.items()
                      if not name.endswith("_ms"))
          + f"; CUDA events {steps['events_ms']:.4f} ms a call (torch.argmax "
          f"{steps['torch_argmax_events_ms']:.4f}); device time "
          + ("not recorded by torch.profiler" if device_us is None
             else f"{device_us:.3f} us (torch.profiler)"), flush=True)

    # -- 2. K1 against its plain version at the main path's shapes
    max_err, times, docs32 = phase_kernel(torch, args.seed)
    parts = "; ".join(
        f"{tag} Q={qp}: K1 {t['k1_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"two-phase top-32 {t['twophase_ms']:.4f} ms, matmul top-32 "
        f"{t['matmul_topk_ms']:.4f} ms"
        for (tag, qp), t in times.items()
    )
    print(f"phase 2 ok: K1 == plain within {SEG_TOL} (max abs err "
          f"{max_err:.3g}) at N={N_ROWS}, n_valid {N_VALID} and {N_VALID + 3}, "
          f"Q {', '.join(map(str, K1_QS))}, and at Q=64 with seg_rows 16 and "
          f"with D=100; "
          f"two-phase top-20 == float64 under the tie rule at each; {parts}",
          flush=True)

    # -- 2b. K1-int8 against its plain version on the same docs
    err_i8, times_i8 = phase_kernel_int8(torch, docs32, args.seed)
    del docs32
    torch.cuda.empty_cache()
    print(f"phase 2b ok: K1-int8 == plain bit for bit (max abs err {err_i8}) "
          f"at N={N_ROWS}, D={DIM}, n_valid {N_VALID} and {N_VALID + 3}; "
          f"int8 two-phase top-20 == the int8-metric brute force; " + "; ".join(
              f"Q={qp}: K1-int8 {t['k1_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, two-phase top-32 {t['twophase_ms']:.4f} ms"
              for qp, t in times_i8.items()), flush=True)

    # -- 2c/2d. K2 against its plain version, and the recovery workload
    err_pq, times_pq, recall, (t_data, t_train), times_w = phase_pq(
        torch, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2c ok: K2 == plain within {PQ_TOL} (max abs err "
          f"{err_pq:.3g}) on {N_PQ} codes (m={PQ_M}, and random codes at m="
          f"{' and '.join(map(str, PQ_WIDTHS))}); pq_topk top-20 == "
          f"float64 ADC under the tie rule at every m; " + "; ".join(
              f"N={n} Q={qp}: K2 {t['k2_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms"
              + (f", pq_topk top-20 {t['pq_topk_ms']:.4f} ms"
                 if "pq_topk_ms" in t else "")
              for (n, qp), t in times_pq.items()) + "; " + "; ".join(
              f"m={m} Q={qp}: K2 {t['k2_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms" for (m, qp), t in times_w.items()),
          flush=True)
    print(f"phase 2d ok: recovery workload ({RECOVERY_N} clustered docs, "
          f"{RECOVERY_Q} queries, corpus {t_data:.1f} s, PQ + OPQ + IVF "
          f"trained and coded on the card in {t_train:.1f} s): post-rescore "
          f"recall@10 at oversample {RECOVERY_OVERSAMPLE}: " + ", ".join(
              f"{name} {recall[name]} (floor {RECOVERY_FLOOR[name]}, "
              f"EVAL_IVF_RECOVERY.json {RECOVERY_REPO[name]})"
              for name in recall), flush=True)

    # -- 2e/2f/2g. the column-major kernels K4 and K3, their entry
    # points, and bench_scale
    docs_cm = colmajor_docs(torch, args.seed)
    wide_t = wide_docs(torch, args.seed)
    err_k4, times_k4 = phase_k4(torch, docs_cm, wide_t, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2e ok: K4 == plain within {CM_TOL} (max abs err "
          f"{err_k4:.3g}) at N={N_CM}, D={DIM}, Q {', '.join(map(str, K4_QS))}"
          f", seg_rows {', '.join(map(str, K4_SEG_ROWS))}, n_valid {N_CM} and "
          f"{N_CM_VALID}, and within {WIDE_TOL:.1e} at N={N_WIDE}, D={WIDE_D},"
          f" seg_rows 8 and 64; dense_topk_twophase top-20 == float64 under "
          f"the tie rule at both widths; " + "; ".join(
              f"{tag} Q={qp} sr={sr}: K4 {t['k4_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, cuBLAS q @ docs_t alone "
              f"{t['cublas_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ("
              f"{t['bound'][1]})" + (f", two-phase top-32 "
                                     f"{t['twophase_ms']:.4f} ms"
                                     if "twophase_ms" in t else "")
              for (tag, qp, sr), t in times_k4.items()), flush=True)
    err_k3, times_k3, k3_cases = phase_k3(torch, docs_cm, wide_t, args.seed)
    del wide_t
    torch.cuda.empty_cache()
    print(f"phase 2f ok: K3 == plain in {k3_cases} cases (scores within "
          f"{K3_TOL}, max abs err {err_k3:.3g}; ids equal under the "
          f"tie-aware rule; duplicate columns first, lowest id first), "
          f"k={K3_BIG_K} at N={N_K3[2]} and k 10 and {K3_BIG_K} at D={WIDE_D} "
          f"included, masked tail with n_valid 40 < k 64 included; " + "; ".join(
              f"{tag} N={n} Q={qp} k={k}: K3 {t['k3_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ("
              f"{t['bound'][1]}), {t['library']}"
              + (f" {t['library_ms']:.4f} ms" if t["library_ms"] is not None
                 else "")
              for (tag, n, qp, k), t in times_k3.items()), flush=True)
    k3_launches = phase_k3_path(torch, docs_cm, args.seed)
    del docs_cm
    torch.cuda.empty_cache()
    print(f"phase 2f ok: ops.dense_topk(fused=True) over {N_K3[0]} docs and "
          f"dense_topk_fused over {N_K3[2]} docs, top-10 == float64 under "
          f"the tie rule; K3 launched {k3_launches}x", flush=True)
    bench_rows, bench_counts = phase_bench(torch)
    torch.cuda.empty_cache()
    print(f"phase 2g ok: bench_scale (bf16, Q=64, k=10) at "
          f"{', '.join(str(n) for n in sorted({r['n'] for r in bench_rows}))}"
          f" docs: recall of the K1 and K4 rows " + ", ".join(
              f"{r['name'].split()[-1]} N={r['n']} {r['recall']}"
              for r in bench_rows if r.get("name", "").startswith("two"))
          + f"; winners " + ", ".join(
              f"N={r['n']} {r['winner']}" for r in bench_rows
              if "winner" in r)
          + f"; K1 launched {bench_counts['K1']}x, K4 "
          f"{bench_counts['K4']}x", flush=True)

    # -- 2h. the timing experiments: X1 and X2, K4 at seg_rows 32, the
    # six scripts
    x1_t, x2_t, cublas_ms, err_k4_32 = phase_probes(torch, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2h ok: X1 == plain at N=1000000 (bf16 [384, N_pad]), "
          f"block maxima bit-equal, in-order sum within {X1_SUM_RTOL} "
          f"relative (max {max(t['sum_rel_err'] for t in x1_t.values()):.3g}); "
          + "; ".join(
              f"bn={bn}: X1 {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"amax {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})" for bn, t in x1_t.items())
          + f". X2 == plain within {X2_TOL} (max abs err "
          f"{max(t['err'] for t in x2_t.values()):.3g}), Q=64; " + "; ".join(
              f"bn={bn}: X2 {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]})"
              for bn, t in x2_t.items())
          + f"; cuBLAS q16 @ docs_t alone (bf16 out) {cublas_ms:.4f} ms. K4 "
          f"seg_rows 32 == plain within {CM_TOL} (max abs err "
          f"{err_k4_32:.3g}; bf16 Q=64, fp32 Q=8, n_valid 1000000 and "
          f"995903)", flush=True)
    exp_rows, exp_counts, exp_recall, exp_secs = phase_experiments(torch)
    torch.cuda.empty_cache()
    print(f"phase 2h ok: {len(EXPERIMENTS)} experiment scripts at their "
          f"default sizes in {exp_secs:.1f} s ({sum(map(len, exp_rows.values()))}"
          f" rows): exp_twophase_rowmajor recall@10 {exp_recall}; every full "
          f"path's top-10 == the flat select's; K1 launched "
          f"{exp_counts['K1']}x, K4 {exp_counts['K4']}x, X1 "
          f"{exp_counts['X1']}x, X2 {exp_counts['X2']}x", flush=True)

    # -- 3. synthetic store at serving scale, with PQ and IVF artifacts
    store, expansions = phase_store(args.docs, args.seed, "cuda")
    check(store.pq_codes is not None and store.ivf_centroids is not None,
          "store lacks its PQ/IVF artifacts")

    # -- 4. the port's main path: HTTP server over the engine on the card
    legal, counts, served = phase_serve(store, args.docs, "cuda")
    engine = legal.engine

    # -- 5. the same searches through a second engine on the CPU
    phase_compare(store, engine, expansions, served)

    # -- 6. the PQ + IVF and int8 engines over HTTP (each refusing
    # maxsim-rerank), then the int8 and flat PQ tiers
    ivf_legal, ivf_counts, _ = phase_serve(store, args.docs, "cuda",
                                           config=pq_ivf_config(), kernel="K2",
                                           phase=6)
    ivf_engine = ivf_legal.engine
    check(ivf_engine.index.ivf_centroids is not None, "PQ engine without IVF")
    phase_serve(store, args.docs, "cuda", config=tier_config("int8"),
                kernel="K1-int8", phase=6)
    torch.cuda.empty_cache()
    tier_engines, tier_counts = phase_tiers(store, args.docs)

    # -- 7. each quantized tier on the card against the CPU
    phase_compare_tiers(store, tier_engines, ivf_engine, engine, expansions)

    # -- 8. the late-interaction modes behind the HTTP server on the fp32
    # engine, the device postings gather, bench_maxsim_scale
    mx = phase_maxsim(store, legal, args.docs)
    st = mx["stages"]
    print(f"phase 8 ok: POST /api/v1/batch_search (3 PRIMARY queries, k=10, "
          f"run at Q={mx['q']}, Tq={mx['tq']}) in maxsim-rerank and maxsim "
          f"mode answered 200 with the planted docs first; full scan == "
          f"float64 MaxSim over the bf16 slab and rerank == exact MaxSim "
          f"over the dense stage's top-20, under the tie rule within "
          f"{MAXSIM_TOL} x real tokens; K1 launched {mx['counts']['K1']}x "
          f"over {MAXSIM_REPS} maxsim-rerank device searches; mean stage ms "
          + "; ".join(f"{mode}: " + ", ".join(
              f"{name} {v['mean_ms']:.3f}" for name, v in st[mode].items())
              for mode in st)
          + f"; slab {mx['slab_gb']:.2f} GB bf16 on the card (uploaded in "
          f"{mx['upload_s']:.1f} s); the scan alone by CUDA events: " + ", ".join(
              f"block {b} {ms:.3f} ms = {mx['slab_gb'] / ms * 1e3:.0f} GB/s of "
              f"the slab ({mx['slab_gb'] / ms * 1e12 / HBM_BYTES_PER_S:.1%} of "
              f"3.35 TB/s)" for b, ms in mx["scan_ms"].items())
          + f" (the engine's block: {mx['block']}); phase wall "
          f"{mx['wall_s']:.1f} s", flush=True)
    wall, busy, top = mx["profile"]
    print(f"phase 8 ok: the scan at block {mx['block']} under torch.profiler: "
          f"wall {wall:.3f} ms, " + (
              "no device time recorded" if busy is None else
              f"device busy {busy:.3f} ms ({busy / wall:.1%}); largest "
              "kernels " + "; ".join(f"{name} {ms:.3f} ms" for name, ms in top)),
          flush=True)
    gather_ms, capped, full, n_gq = phase_gather(store, expansions)
    print(f"phase 8b ok: device postings gather of {n_gq} queries (PRIMARY, "
          f"the victim's expansions, padding) == the host gather at the "
          f"uncapped budget {full}; at the engine's budget {capped}, ms a "
          f"batch (postings on the card; turns host, device, device, host):"
          f" host gather + upload "
          f"{' / '.join(f'{t:.3f}' for t in gather_ms['host'])}, device "
          f"gather {' / '.join(f'{t:.3f}' for t in gather_ms['device'])}",
          flush=True)
    del engine._mv_index
    torch.cuda.empty_cache()
    from legal_rag_tpu_torch.scripts import bench_maxsim_scale

    bms = bench_maxsim_scale.run(
        log=lambda line: print(f"phase 8c: {line}", flush=True))
    check(bms["top1"] >= 0.9, f"bench_maxsim_scale top-1 agreement "
          f"{bms['top1']}")
    torch.cuda.empty_cache()
    print(f"phase 8c ok: bench_maxsim_scale at N={bms['n']}, Q={bms['q']}: "
          f"full scan {bms['full_ms']:.3f} ms ({bms['slab_gbps']:.0f} GB/s, "
          f"{bms['slab_share']:.1%} of 3.35 TB/s), rerank "
          f"{bms['rerank_ms']:.3f} ms, top-1 agreement {bms['top1']}, top-10 "
          f"overlap {bms['overlap']}", flush=True)

    # -- 9. the build path: ingest, build (fine-tune, PQ + IVF, token
    # slab, CE and its gate), serve, the card against the CPU
    b = phase_build(args.seed)
    torch.cuda.empty_cache()
    print_build(b)

    check("jax" not in sys.modules, "the run imported jax")
    jax_pkg = sorted(m for m in sys.modules if m == "legal_rag_tpu"
                     or m.startswith("legal_rag_tpu."))
    check(not jax_pkg, f"the run imported the JAX package: {jax_pkg}")
    # each kernel's line at the main path's shapes: fp32, 8 queries (X1
    # and X2: the roofline experiment's bf16 docs, 64 queries, bn 8192)
    k1_t, k1_i8_t, k2_t = times[("fp32", 8)], times_i8[8], times_pq[(N_PQ, 8)]
    # the served batches of 64 and 68 (run at Q=128): the tensor cores
    k1_64, k1_128 = times[("fp32", 64)], times[("fp32", 128)]
    k3_t, k4_t = times_k3[("fp32", N_K3[2], 8, 10)], times_k4[("fp32", 8, 8)]
    # K4 at bench_scale's batch: bf16, 64 queries
    k4_64 = times_k4[("bf16", 64, 8)]
    n_rows = engine.index.docs.shape[0]     # the maxsim-rerank dense stage
    rows = [
        ("segmax_rm (K1)", "segmax_rm.cu", "legal_rag_tpu/ops/dense.py:495",
         counts["K1"], max_err, k1_t["k1_ms"], k1_t["plain_ms"],
         bound(N_ROWS * DIM * 4 + 8 * DIM * 4 + 8 * N_ROWS // 8 * 4,
               2 * 8 * N_ROWS * DIM, "fp32"), None),
        # fp32 products as 3xTF32 computes them: three TF32 products each
        ("segmax_rm tensor cores (K1, Q=64)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:495", served[64][1]["K1 tensor cores"],
         max_err, k1_64["k1_ms"], k1_64["plain_ms"],
         bound(N_ROWS * DIM * 4 + 64 * DIM * 4 + 64 * N_ROWS // 8 * 4,
               3 * 2 * 64 * N_ROWS * DIM, "tf32"), None),
        ("segmax_rm tensor cores (K1, Q=128)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:495", served[68][1]["K1 tensor cores"],
         max_err, k1_128["k1_ms"], k1_128["plain_ms"],
         bound(N_ROWS * DIM * 4 + 128 * DIM * 4 + 128 * N_ROWS // 8 * 4,
               3 * 2 * 128 * N_ROWS * DIM, "tf32"), None),
        # the maxsim-rerank dense stage: the same fp32 Q=8 launches
        ("segmax_rm (K1, maxsim-rerank)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:495", mx["counts"]["K1"], max_err,
         k1_t["k1_ms"], k1_t["plain_ms"],
         bound(n_rows * DIM * 4 + 8 * DIM * 4 + 8 * n_rows // 8 * 4,
               2 * 8 * n_rows * DIM, "fp32"), None),
        ("segmax_rm int8 (K1-int8)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:515", tier_counts["int8"]["K1-int8"],
         err_i8, k1_i8_t["k1_ms"], k1_i8_t["plain_ms"],
         bound(N_ROWS * DIM + 8 * DIM + 8 * N_ROWS // 8 * 4,
               2 * 8 * N_ROWS * DIM, "int8"), None),
        ("pq_segmax (K2)", "pq_segmax.cu", "legal_rag_tpu/ops/pq.py:257",
         ivf_counts["K2"] + tier_counts["pq"]["K2"], err_pq, k2_t["k2_ms"],
         k2_t["plain_ms"],
         bound(N_PQ * PQ_M + 8 * 2 * PQ_M * 16 * 2 + 8 * N_PQ // 8 * 4,
               8 * N_PQ * 2 * PQ_M, "fp32"), None),
        ("fused_topk (K3)", "fused_topk.cu", "legal_rag_tpu/ops/dense.py:147",
         k3_launches, err_k3, k3_t["k3_ms"], k3_t["plain_ms"], k3_t["bound"],
         k3_t["library_ms"]),
        ("segmax_cm (K4)", "segmax_cm.cu", "legal_rag_tpu/ops/dense.py:277",
         bench_counts["K4"], err_k4, k4_t["k4_ms"], k4_t["plain_ms"],
         k4_t["bound"], None),
        ("segmax_cm (K4, bf16 Q=64)", "segmax_cm.cu",
         "legal_rag_tpu/ops/dense.py:277", bench_counts["K4"], err_k4,
         k4_64["k4_ms"], k4_64["plain_ms"], k4_64["bound"], None),
        ("argmax_probe (P)", "argmax_probe.cu", "tests/test_tpu_hardware.py:53",
         probe["launches"], 0, probe["ms"], probe["plain_ms"],
         bound(8 * 256 * 4 + 8 * 4, 8 * 256, "fp32"), probe["library_ms"]),
        ("stream_probe (X1)", "stream_probe.cu",
         "scripts/exp_dense_roofline.py:188", exp_counts["X1"], 0.0,
         x1_t[8192]["ms"], x1_t[8192]["plain_ms"], x1_t[8192]["bound"],
         x1_t[8192]["library_ms"]),
        ("mm_rowmax (X2)", "mm_rowmax.cu", "scripts/exp_dense_roofline.py:220",
         exp_counts["X2"], x2_t[8192]["err"], x2_t[8192]["ms"],
         x2_t[8192]["plain_ms"], x2_t[8192]["bound"], None),
    ]
    for name, _, _, launches, *_ in rows:
        check(launches > 0, f"{name} was not launched on its path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"legal_rag_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
         "library_ms": library_ms}
        for name, src, replaces, launches, err, ms, plain_ms, bnd, library_ms
        in rows
    ]}))

    print(f"total {time.time() - t_start:.1f} s; {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
