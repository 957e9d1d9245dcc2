#!/usr/bin/env python3
"""Smoke run of the PyTorch port (legal_rag_tpu_torch) on one CUDA card.

Phases, one output line each:

1. the card (name and power limit from nvidia-smi), the build of
   kernels K1, K2, K3, K4 and the probe P from the CUDA sources in this
   checkout (one nvcc each, started together), with ptxas's registers
   per instantiation, and P launched on its tie input (33 expected);
2. K1 against its plain PyTorch version at the main path's shapes
   (1,000,000 docs padded to 1,007,616 rows, D=384, 8 and 64 queries,
   fp32 and bf16, odd n_valid, duplicate rows), the whole two-phase
   top-k against a float64 brute force, and both versions' times;
2b. K1's int8 variant against its plain version on phase 2's docs
   quantized per segment: int32 maps bit-equal, the int8 two-phase
   top-20 equal to an int8-metric brute force, both versions' times;
2c. K2 against its plain version on 1,000,000 PQ codes (m=48) of a
   clustered corpus, pq_topk's top-20 against a float64 ADC brute
   force, and both versions' times there and on 10,000,000 codes;
2d. the PQ/IVF recovery workload of scripts/exp_ivf_recovery.py on the
   card (1,048,576 clustered docs, 64 queries, post-rescore recall@10
   at oversample 64, flat and at 512 probes);
2e. K4 against its plain version on column-major docs (1,048,576 docs,
   D=384, 8 and 64 queries, fp32 and bf16, seg_rows 8 and 16, odd
   n_valid, duplicate columns), dense_topk_twophase's top-20 against a
   float64 brute force, both versions' times;
2f. K3 against its plain version (2,620, 65,536 and 1,007,616 docs, 8
   and 64 queries, k 10 and 64, fp32 and bf16, and a masked tail with
   n_valid < k): ids equal, scores within 1e-5; times beside the plain
   version's and torch.topk over a matmul's; then the fused entry
   points (ops.dense_topk(fused=True) over the 2,620-doc corpus,
   dense_topk_fused over 1,007,616 docs) with K3's launches counted;
2g. the port's bench_scale at its default sizes with the column-major
   row (matmul + top-k, K1's and K4's two-phase searches, bf16, 64
   queries, k=10): its table, recall of the K1 and K4 rows >= 0.999,
   and K1's and K4's launches over that run;
3. a synthetic store made from --seed (default 1,000,000 docs) with
   its PQ and IVF artifacts, saved with the port's VectorStore.save
   under build/ and loaded back;
4. the port's LegalEngine on the card behind the HTTP server: three
   POST /api/v1/query requests (victim narrative, procedural, heading)
   and one POST /api/v1/batch_search, each checked for its planted
   doc, with K1's launch count over exactly that run;
5. the same search_batch calls through a second engine on the CPU,
   equal to the card's under the tie-aware rule;
6. the PQ + IVF engine behind the HTTP server (the same requests and
   checks), then the int8 and the flat PQ engines through
   search_batch, with K2's and K1-int8's launch counts over those runs;
7. each quantized tier's search_batch on the card equal to a CPU
   engine's under the tie-aware rule, and the int8 engine's weighted
   results equal to the fp32 engine's.

Then a JSON line with each kernel's launches, error, times and bound,
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
import urllib.request

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

VICTIM = ("I was robbed at gunpoint just now, what is the procedure and "
          "what are the rights of the victim?")
PROCEDURAL = "What is the procedure to file an FIR?"
HEADING = "punishment for robbery"
PRIMARY = (VICTIM, PROCEDURAL, HEADING)

N_ROWS, N_VALID, DIM = 1_007_616, 1_000_000, 384
SEG_TOL = 1e-5      # K1 vs plain: fp32 sums of 384 products of unit-vector
                    # entries (|score| <= 1) in another order
PQ_TOL = 1e-5       # K2 vs plain: fp32 sums of 96 bf16 table entries
                    # (|score| ~ 1) in another order
PQ_M = 48
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
N_CM, N_CM_VALID = 1 << 20, 1_000_003     # K4's docs; an odd n_valid
N_K3 = (2_620, 65_536, 1_007_616)   # the serving corpus, LARGE_N_THRESHOLD,
                                    # the 1M store's padded rows
K3_TOL = 1e-5
# one H100 SXM, dense peak rates from NVIDIA's H100 data sheet
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_cuda(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def assert_topk_equiv_scores(torch, s64, k, got_s, got_i):
    """The tie-aware rule against given float64 scores ``s64 [Q, N]``."""
    n_valid = s64.shape[1]
    srt = torch.topk(s64, k, dim=1).values
    kth = srt[:, k - 1:k]
    got_s = got_s.double()
    got_i = got_i.long()
    check(bool((got_i < n_valid).all()), "top-k returned a masked row")
    got_true = torch.gather(s64, 1, got_i)
    check(float((got_s - srt).abs().max()) <= TOPK_TOL, "top-k values")
    check(float((got_s - got_true).abs().max()) <= TOPK_TOL, "top-k scores")
    check(bool((got_s[:, 1:] - got_s[:, :-1] <= TOPK_TOL).all()), "order")
    check(bool((got_true >= kth - TOPK_TOL).all()), "id below the tie band")
    for qi in range(s64.shape[0]):
        must = torch.nonzero(s64[qi] > kth[qi] + TOPK_TOL).flatten()
        check(set(must.tolist()) <= set(got_i[qi].tolist()), "missing hit")


def phase_kernel(torch, seed: int):
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
        for qp in (8, 64):
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
            p1, k1a, k1b, p2 = (time_cuda(torch, f) for f in (plain, k1, k1, plain))
            two = time_cuda(torch, lambda: dense_topk_twophase_rm(
                q, docs, 32, n_valid=N_VALID))
            full = time_cuda(torch, lambda: dense_topk_matmul(
                q, docs[:N_VALID], 32))
            times[(tag, qp)] = {
                "k1_ms": (k1a + k1b) / 2, "plain_ms": (p1 + p2) / 2,
                "twophase_ms": two, "matmul_topk_ms": full,
            }
        del docs
    return max_err, times, docs32


def phase_kernel_int8(torch, docs32, seed: int):
    """K1-int8 against its plain version on ``docs32`` quantized per
    segment (the int8 tier's ShardedIndex); returns the times."""
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
    for qp in (8, 64):
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
        p1, k1a, k1b, p2 = (time_cuda(torch, f) for f in (plain, k1, k1, plain))
        two = time_cuda(torch, lambda: dense_topk_twophase_rm(
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
    for qp in (8, 64):
        q = qrot[:qp].contiguous()
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
        p1, ka, kb, p2 = (time_cuda(torch, f) for f in (plain, k2, k2, plain))
        top = time_cuda(torch, lambda: pq_topk(q, codes_1m, cbs, 20))
        times[(N_PQ, qp)] = {"k2_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                             "pq_topk_ms": top}
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    big = torch.randint(0, 256, (N_PQ_BIG, PQ_M), generator=g, device=dev,
                        dtype=torch.uint8)
    for qp in (8, 64):
        lut = pq_lut(qrot[:qp], cbs).to(torch.bfloat16).contiguous()
        k2 = lambda: pq_segmax(lut, big)
        plain = lambda: pq_segmax_reference(lut, big)
        p1, ka, kb, p2 = (time_cuda(torch, f, iters=5, warmup=1)
                          for f in (plain, k2, k2, plain))
        times[(N_PQ_BIG, qp)] = {"k2_ms": (ka + kb) / 2,
                                 "plain_ms": (p1 + p2) / 2}
    del big

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
    return max_err, times, recall, (t_data, t_train)


def phase_probe(torch) -> dict:
    """P on its tie input: equal to its plain version and 33 on every
    row; its launches over exactly that call, and the times of the
    kernel, the plain version and torch.argmax."""
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
    plain = lambda: row_argmax_reference(x)
    p1, ka, kb, p2 = (time_cuda(torch, f) for f in (plain, kernel, kernel, plain))
    return {"rows": 33, "launches": launches, "ms": (ka + kb) / 2,
            "plain_ms": (p1 + p2) / 2,
            "library_ms": time_cuda(torch, lambda: torch.argmax(x, dim=1))}


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


def phase_k4(torch, docs32, seed: int):
    """K4 against its plain version, and dense_topk_twophase's top-20
    against float64; returns the max error and the times."""
    from legal_rag_tpu_torch.ops.dense import dense_topk_twophase
    from legal_rag_tpu_torch.ops.segmax_cm import (
        n_segments, segmax_cm, segmax_cm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    max_err, times = 0.0, {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        docs_t = docs32.T.contiguous().to(dtype)
        for qp in (8, 64):
            q = unit_queries(torch, g, qp, docs32).to(dtype)
            for seg_rows in (8, 16):
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
                k4 = lambda: segmax_cm(q, docs_t, N_CM, seg_rows)
                plain = lambda: segmax_cm_reference(q, docs_t, N_CM, seg_rows)
                p1, ka, kb, p2 = (time_cuda(torch, f)
                                  for f in (plain, k4, k4, plain))
                elt = docs_t.element_size()
                times[(tag, qp, seg_rows)] = {
                    "k4_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                    "bound": bound(
                        N_CM * DIM * elt + qp * DIM * elt
                        + qp * n_segments(N_CM, seg_rows) * 4,
                        2 * qp * N_CM * DIM, tag),
                }
            s, i = dense_topk_twophase(q, docs_t, 20, n_valid=N_CM_VALID)
            assert_topk_equiv(torch, q.float(), docs_t.T.float(), N_CM_VALID,
                              20, s, i)
            check({123, *range(500_000, 500_019)} <= set(i[1].tolist()),
                  "K4 two-phase: duplicate ties")
            times[(tag, qp, 8)]["twophase_ms"] = time_cuda(
                torch, lambda: dense_topk_twophase(q, docs_t, 32))
        del docs_t
    return max_err, times


def phase_k3(torch, docs32, seed: int):
    """K3 against its plain version (equal ids, scores within K3_TOL);
    returns the max error, the times and the count of cases whose
    scores were bit-equal."""
    from legal_rag_tpu_torch.ops.fused_topk import (
        fused_topk, fused_topk_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    max_err, times, cases, bit_equal = 0.0, {}, 0, 0

    def compare(q, docs_t, k, n_valid=None, what=""):
        nonlocal max_err, cases, bit_equal
        got_s, got_i = fused_topk(q, docs_t, k, n_valid)
        ref_s, ref_i = fused_topk_reference(q, docs_t, k, n_valid)
        torch.cuda.synchronize()
        check(got_s.shape == (q.shape[0], k), f"K3 shape {what}")
        check(torch.equal(got_i, ref_i), f"K3 ids {what}: "
              f"{int((got_i != ref_i).sum())} differ")
        err = float((got_s - ref_s).abs().max())
        check(err <= K3_TOL, f"K3 scores {what}: error {err}")
        max_err = max(max_err, err)
        cases += 1
        bit_equal += bool(torch.equal(got_s, ref_s))
        return got_s, got_i

    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        full = docs32.T.contiguous().to(dtype)
        for n in N_K3:
            docs_t = full[:, :n]          # a column slice: row stride N_CM
            for qp in (8, 64):
                q = unit_queries(torch, g, qp, docs32).to(dtype)
                for k in (10, 64):
                    _, i = compare(q, docs_t, k, what=f"{tag} N={n} Q={qp} k={k}")
                    if n > 500_040:
                        dups = range(500_000, 500_000 + min(k - 1, 40))
                        check({123, *dups} <= set(i[1].tolist()),
                              "K3 duplicate ties")
                it, wu = (5, 1) if n > 100_000 else (20, 3)
                k3 = lambda: fused_topk(q, docs_t, 10)
                plain = lambda: fused_topk_reference(q, docs_t, 10)
                p1, ka, kb, p2 = (time_cuda(torch, f, iters=it, warmup=wu)
                                  for f in (plain, k3, k3, plain))
                elt = docs_t.element_size()
                t = {"k3_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                     "bound": bound(n * DIM * elt + qp * DIM * elt
                                    + qp * 10 * 8, 2 * qp * n * DIM, tag),
                     "library_ms": None}
                if dtype == torch.float32:
                    t["library_ms"] = time_cuda(
                        torch, lambda: torch.topk(q @ docs_t, 10, dim=1))
                times[(tag, n, qp)] = t
        # the masked tail: n_valid < k, masked ids ascending at finfo.min
        q = unit_queries(torch, g, 8, docs32).to(dtype)
        s, i = compare(q, full[:, :N_K3[0]], 64, n_valid=40,
                       what=f"{tag} masked tail")
        check(bool((i[:, 40:] == torch.arange(40, 64, device="cuda")).all()),
              "K3 masked tail ids")
        check(bool((s[:, 40:] == torch.finfo(torch.float32).min).all()),
              "K3 masked tail scores")
        del full
    return max_err, times, (cases, bit_equal)


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


def post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"{url}: HTTP {r.status}")
        return json.loads(r.read())


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
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.retrieval.classifier import QueryClassifier
    from legal_rag_tpu_torch.retrieval.orchestrator import expansion_queries

    t0 = time.time()
    expansions = expansion_queries(QueryClassifier().classify(VICTIM))
    store = synthesize_store(
        n_docs, seed=seed, planted=PRIMARY, vocab_queries=expansions,
        device=device,
    )
    store_dir = os.path.join(REPO_ROOT, "build", "smoke_store")
    store.save(store_dir)
    del store
    store = VectorStore.load(store_dir)
    print(f"phase 3 ok: {store.n_docs} docs, {len(store.bm25.doc_ids)} "
          f"postings, BM25 vocab {store.bm25.vocab_size}, mean length "
          f"{store.bm25.avgdl:.1f} tokens, WordPiece vocab "
          f"{len(store.wp_vocab)}; built, saved and loaded in "
          f"{time.time() - t0:.1f} s", flush=True)
    return store, expansions


def reset_counts() -> None:
    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1

    K1.launches = K1.int8_launches = K2.launches = 0
    K3.launches = K4.launches = P.launches = 0


def read_counts() -> dict:
    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1

    return {"K1": K1.launches, "K1-int8": K1.int8_launches,
            "K2": K2.launches, "K3": K3.launches, "K4": K4.launches,
            "P": P.launches}


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
    """Drive the main path over HTTP; returns the engine and the launch
    counts over exactly that run (``kernel`` must have launched at
    least once per device search)."""
    import torch

    from legal_rag_tpu_torch.cli import BackgroundServer
    from legal_rag_tpu_torch.index.synthetic import planted_ids
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
    finally:
        server.stop()
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
    tier = engine.config.dense.dtype + (
        " + IVF" if engine.index.ivf_centroids is not None else "")
    print(f"phase {phase} ok: {tier} engine: 3 /api/v1/query + 1 "
          f"/api/v1/batch_search answered 200 in {wall:.2f} s with planted "
          f"docs found; {dispatches} device searches, {kernel} launched "
          f"{counts[kernel]}x; cross-encoder scored "
          f"{n_ce} pools (rerank_score present); mean stage ms: "
          + ", ".join(f"{k} {v['mean_ms']:.2f}" for k, v in stages.items()),
          flush=True)
    if device == "cuda":
        check(counts[kernel] >= dispatches, f"{kernel} launched "
              f"{counts[kernel]} times for {dispatches} device searches")
    return engine, counts


def phase_compare(store, engine, expansions):
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
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1

    def build(kernel):
        t0 = time.time()
        kernel.library()
        return time.time() - t0

    kernels = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "P": P}
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

    # -- 2. K1 against its plain version at the main path's shapes
    max_err, times, docs32 = phase_kernel(torch, args.seed)
    parts = "; ".join(
        f"{tag} Q={qp}: K1 {t['k1_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"two-phase top-32 {t['twophase_ms']:.4f} ms, matmul top-32 "
        f"{t['matmul_topk_ms']:.4f} ms"
        for (tag, qp), t in times.items()
    )
    print(f"phase 2 ok: K1 == plain within {SEG_TOL} (max abs err "
          f"{max_err:.3g}) at N={N_ROWS}, n_valid {N_VALID} and {N_VALID + 3}; "
          f"two-phase top-20 == float64 under the tie rule; {parts}", flush=True)

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
    err_pq, times_pq, recall, (t_data, t_train) = phase_pq(torch, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2c ok: K2 == plain within {PQ_TOL} (max abs err "
          f"{err_pq:.3g}) on {N_PQ} codes (m={PQ_M}); pq_topk top-20 == "
          f"float64 ADC under the tie rule; " + "; ".join(
              f"N={n} Q={qp}: K2 {t['k2_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms"
              + (f", pq_topk top-20 {t['pq_topk_ms']:.4f} ms"
                 if "pq_topk_ms" in t else "")
              for (n, qp), t in times_pq.items()), flush=True)
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
    err_k4, times_k4 = phase_k4(torch, docs_cm, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2e ok: K4 == plain within {CM_TOL} (max abs err "
          f"{err_k4:.3g}) at N={N_CM}, D={DIM}, seg_rows 8 and 16, n_valid "
          f"{N_CM} and {N_CM_VALID}; dense_topk_twophase top-20 == float64 "
          f"under the tie rule; " + "; ".join(
              f"{tag} Q={qp} sr={sr}: K4 {t['k4_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ("
              f"{t['bound'][1]})" + (f", two-phase top-32 "
                                     f"{t['twophase_ms']:.4f} ms"
                                     if "twophase_ms" in t else "")
              for (tag, qp, sr), t in times_k4.items()), flush=True)
    err_k3, times_k3, (k3_cases, k3_bits) = phase_k3(torch, docs_cm, args.seed)
    torch.cuda.empty_cache()
    print(f"phase 2f ok: K3 == plain in {k3_cases} cases (ids equal, scores "
          f"within {K3_TOL}, max abs err {err_k3:.3g}, bit-equal in "
          f"{k3_bits}), masked tail with n_valid 40 < k 64 included; "
          + "; ".join(
              f"{tag} N={n} Q={qp} k=10: K3 {t['k3_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ("
              f"{t['bound'][1]})" + (f", torch.topk(q @ docs_t) "
                                     f"{t['library_ms']:.4f} ms"
                                     if t["library_ms"] is not None else "")
              for (tag, n, qp), t in times_k3.items()), flush=True)
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

    # -- 3. synthetic store at serving scale, with PQ and IVF artifacts
    store, expansions = phase_store(args.docs, args.seed, "cuda")
    check(store.pq_codes is not None and store.ivf_centroids is not None,
          "store lacks its PQ/IVF artifacts")

    # -- 4. the port's main path: HTTP server over the engine on the card
    engine, counts = phase_serve(store, args.docs, "cuda")

    # -- 5. the same searches through a second engine on the CPU
    phase_compare(store, engine, expansions)

    # -- 6. the PQ + IVF engine over HTTP, then the int8 and flat PQ tiers
    ivf_engine, ivf_counts = phase_serve(store, args.docs, "cuda",
                                         config=pq_ivf_config(), kernel="K2",
                                         phase=6)
    check(ivf_engine.index.ivf_centroids is not None, "PQ engine without IVF")
    tier_engines, tier_counts = phase_tiers(store, args.docs)

    # -- 7. each quantized tier on the card against the CPU
    phase_compare_tiers(store, tier_engines, ivf_engine, engine, expansions)

    check("jax" not in sys.modules, "the run imported jax")
    jax_pkg = sorted(m for m in sys.modules if m == "legal_rag_tpu"
                     or m.startswith("legal_rag_tpu."))
    check(not jax_pkg, f"the run imported the JAX package: {jax_pkg}")
    # each kernel's line at the main path's shapes: fp32, 8 queries
    k1_t, k1_i8_t, k2_t = times[("fp32", 8)], times_i8[8], times_pq[(N_PQ, 8)]
    k3_t, k4_t = times_k3[("fp32", N_K3[2], 8)], times_k4[("fp32", 8, 8)]
    rows = [
        ("segmax_rm (K1)", "segmax_rm.cu", "legal_rag_tpu/ops/dense.py:495",
         counts["K1"], max_err, k1_t["k1_ms"], k1_t["plain_ms"],
         bound(N_ROWS * DIM * 4 + 8 * DIM * 4 + 8 * N_ROWS // 8 * 4,
               2 * 8 * N_ROWS * DIM, "fp32"), None),
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
        ("argmax_probe (P)", "argmax_probe.cu", "tests/test_tpu_hardware.py:53",
         probe["launches"], 0, probe["ms"], probe["plain_ms"],
         bound(8 * 256 * 4 + 8 * 4, 8 * 256, "fp32"), probe["library_ms"]),
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
