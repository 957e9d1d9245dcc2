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
   same on 1,000,000 random codes at m=24 and m=96; K2 at every seg_rows
   it takes (1-64) at 8 and 64 queries on the 1,000,000 codes, against
   its plain version, pq_topk(seg_rows=16)'s top-10 against float64 ADC,
   and both versions' times at seg_rows 16;
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
2i. the kernel scripts of the evaluation slice at reduced size
   (SCRIPT_SIZES; 5 timed calls a row): exp_rm_sweep (K1 and K1-int8,
   every (block_n, seg_rows) config, int8, sup 64 and 256),
   exp_twophase_full (K4: unpadded, prepadded, kk32, noemit, with the
   memory a call allocates), bench_pq (K2, its rows timed at seg_rows 8
   and 16) and exp_ivf_recovery (K2) on the
   card and exp_ivf_recovery_recall's numpy mirror on the host: every
   two-phase top-10 equal to the flat select's (recall@10 1.0 but the
   int8 metric's row), the recovery floors at oversample 64, the card's
   pq dispatch returning >= 0.99 of the mirror's candidates, and K1's,
   K1-int8's, K2's and K4's launches over that run;
3. a synthetic store made from --seed (default 1,000,000 docs) with
   its PQ and IVF artifacts, saved with the port's VectorStore.save
   under build/ and loaded back, and its late-interaction slab (8
   tokens a doc, float16, 6.1 GB at 1M docs) drawn on the card and
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
   ingest.synthetic), ``ingest`` and ``build --finetune-steps 100
   --finetune-token-weight 0.5 --pq-m 48 --ivf-cell-size 256
   --rerank-steps 100 --multi-vector 32`` through the port's command
   line on the card (losses falling, the gate's verdict and alpha, the
   stage times), the store served by ``python -m legal_rag_tpu_torch
   serve`` in a process of its own, each of three titles' own chunks in
   its /api/v1/query context and its batch_search top 10; an untrained
   256-chunk build on the card equal to the CPU's (embeddings within
   1e-5, BM25 and corpus_hash equal); the encode throughput over 16,384
   chunks at batches 64 and 512 beside the fp32 FLOP bound, and the
   fine-tune and CE steps' ms.
10. the evaluation path over phase 9's store: ``eval
   --include-paraphrase``, ``eval-gate`` and ``eval-retrieval
   --include-pq --include-maxsim`` through ``python -m
   legal_rag_tpu_torch`` on the card, each in a process of its own with
   its report under build/smoke_eval (each exit code as its report's
   gate says; a 100-step store fails the serving floors), their wall
   seconds, tables and provenance (platform gpu, the card's name);
   eval-retrieval's recall@10 and MRR a mode equal to a CPU run's
   within 2/n; K2's launches over the pq mode of ``evaluate_store`` in
   this process, and K2 at the eval's shape against its plain version;
   ``run_retrieval_gate`` at the untrained CI floors; diag_paraphrase,
   eval_fusion_policy (bootstrap 100), exp_paraphrase_sparse and
   eval_ce_paraphrase (100 queries a split) on the same store, the two
   that rerank over a copy with a 10-step CE persisted on purpose (the
   build's gate persists a CE at this depth only when it does not lower
   the held-out MRR).
11. the C++ WordPiece tokenizer on the card's host: built by g++ from
   legal_rag_tpu_torch/native/ into build/, phase 9's store recording
   ``tokenizer_impl: native-cpp`` (anything else fails the run), its
   ids equal to the Python tokenizer's on all 2,620 chunks and on
   tests/test_native.py's adversarial and Unicode fuzz inputs, both
   tokenizers' docs/s, and phase 9's build seconds beside the same
   build with the Python tokenizer;
12. the benches: bench_hybrid_scale at 1,000,000 docs (capped and
   uncapped hybrid ms a batch of 64, the host gather, the capped sparse
   recall and the hybrid overlap, K1's launches on its dense stage) and
   bench_http over phase 9's store (2 requests a client at concurrency
   1 and 16; coalesced, uncoalesced and no-rerank passes, zero errors);
13. the deployment entry points start_torch.sh and spaces_app_torch.py
   over phase 9's store, each ready on /health, one /api/v1/query
   answered 200, then stopped by SIGTERM to its process group;
14. multi-GPU sharding on the one card (every mesh position on cuda:0):
   sharded_hybrid_search at S=2 over phase 3's fp32 store (507,904 rows
   a shard, K1 once a shard), RRF and weighted over 64 queries, equal to
   the served S=1 search under the tie rule and placed as the float64
   channels allow, with both searches' ms and the candidates' gather
   alone at S=2 and 4; a 2x2 (data, shard) mesh equal to S=2; two
   processes on cuda:0 over gloo (world 2) and one over NCCL (world 1),
   spawned together, equal to this process's S=2 and S=1; PQ at S=4
   over phase 2d's codes (K2 once a shard, flat equal to S=1) and IVF at
   512 probes a shard above the 0.94 recall floor; both MaxSim modes at
   S=2 over the slab's first 65,536 docs (the scan equal to S=1, the
   rerank equal to exact float64 MaxSim over each shard's own dense
   top-20); three fine-tune steps at S=2 within 1e-4 of S=1's losses;
   K2 at seg_rows 3 and 12 against its plain version and pq_topk there
   against float64 ADC;
15. the headline bench (legal_rag_tpu_torch/bench.py, the counterpart
   of bench.py) over phase 9's store: the batch-64 hybrid search's
   device time by the slope over a CUDA graph (and the 8-wide single
   query's), the eager sync and pipelined ms, the single-query p50/p90,
   the dispatch floor, the CPU baseline and both encode rates, each
   finite and positive; the batch's ids equal to the exact golden's
   (recall@5 1.0 but for ties within TOPK_TOL), to cpu_baseline's and
   to the captured graph's under the tie rule; its record on a line of
   its own;
16. the served programs as CUDA graphs (utils/graphs.py; the engines
   of phases 4-8 already serve through them): over phase 3's store and
   phase 9's, every tier (fp32, bf16, int8, flat PQ, PQ + IVF) in
   weighted and RRF mode at 1, 5, 8 and 64 real queries (GRAPH_LIGHT's
   words, without the corpus's head words) through a fresh
   graph set whose every capture warms up under
   set_sync_debug_mode("error"), the replay's rows equal to the eager
   run's of the same engine bit for bit; K1, K1-int8 and K2 launched
   inside replays at 1M docs; each graph set's graphs, capture seconds
   and pool bytes; the fp32 engine's StageTimer stages and wall p50
   over the PRIMARY queries (GRAPH_TIMED: 1 and 8 at 1M docs, also 64
   at 2,620) in turns eager, graph, graph, eager; then 16b,
   the serving path over phase 9's store with a CE, the server's warm-up
   queries, the encoder's and the CE's replays equal to their eager
   runs, bench_http's clients against an in-process server in turns,
   and the graphs and pool bytes after the warm-up and after the load.

Then each phase's seconds, a JSON line with each kernel's launches
(``launches_in_replays`` of them inside CUDA-graph replays), error,
times and bound (K4 at fp32 Q=8 and at bench_scale's bf16 Q=64; K1 also
on the maxsim-rerank path, bench_hybrid_scale's and the S=2 search; K2
also on the eval path's pq mode, at seg_rows 16, 3 and 12 and at S=4;
K1, K1-int8 and K2 in phase 16's replays), and last ``{"ok": true,
"device": {...}}``. Any failed check raises, so
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
PQ_SEG_ROWS = (1, 2, 4, 8, 16, 32, 64)   # the segments K2 takes
PQ_SEG_QS = (8, 64)                      # their query batches
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
# the kernel scripts' reduced sizes in phase 2i (their defaults: 2^20 or
# 1,000,000 docs; PERF.md has the full-size tables): 125,000 is not a
# multiple of the 8,192-column padding unit, so exp_twophase_full's
# unpadded and prepadded cases differ; the numpy mirror runs on the host
SCRIPT_SIZES = {"exp_rm_sweep": 1 << 17, "exp_twophase_full": 125_000,
                "bench_pq": 1 << 17, "exp_ivf_recovery": 1 << 17,
                "exp_ivf_recovery_recall": 1 << 15}
# the card's pq dispatch against the numpy mirror's candidates: fp32
# table sums in another order may trade a near-tied candidate at the cut
SCRIPT_OVERLAP = 0.99
MV_TD = 8           # the token slab's budget (`build --multi-vector 8`;
                    # 6.1 GB at 1M docs, the smoke's time cut from 32)
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
    docs_i8, doc_scales = idx.docs.full(), idx.doc_scales.full()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    max_err, times = 0, {}
    for qp in K1_QS:
        q = torch.randn(qp, DIM, generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        q[1] = docs32[123]
        q_i8, q_scale = quantize_queries(q)
        for n_valid in (N_VALID, N_VALID + 3):
            got = segmax_rm(q_i8, docs_i8, n_valid)
            ref = segmax_rm_reference(q_i8, docs_i8, n_valid)
            torch.cuda.synchronize()
            check(got.dtype == ref.dtype == torch.int32, "K1-int8 dtype")
            check(got.shape == (qp, N_ROWS // 8), "K1-int8 shape")
            check(torch.equal(got, ref), f"K1-int8 Q={qp} n_valid {n_valid}: "
                  f"{int((got != ref).sum())} map entries differ")
            max_err = max(max_err, int((got - ref).abs().max()))
        # the two-phase top-20 is the exact top-20 of the int8 metric
        s, i = dense_topk_twophase_rm(q, docs_i8, 20, n_valid=N_VALID,
                                      doc_scales=doc_scales)
        acc = q_i8.float() @ docs_i8[:N_VALID].float().T
        full = acc * q_scale[:, None] * doc_scales[:N_VALID][None, :]
        ids = torch.arange(N_VALID, device=dev).expand(qp, N_VALID)
        want_s, want_i = sort_score_desc_id_asc(full, ids)
        check(torch.equal(i.long(), want_i[:, :20]), "int8 top-20 ids")
        check(torch.equal(s, want_s[:, :20]), "int8 top-20 scores")
        k1 = lambda: segmax_rm(q_i8, docs_i8, N_VALID)
        plain = lambda: segmax_rm_reference(q_i8, docs_i8, N_VALID)
        p1, k1a, k1b, p2 = (time_ms(f) for f in (plain, k1, k1, plain))
        two = time_ms(lambda: dense_topk_twophase_rm(
            q, docs_i8, 32, n_valid=N_VALID, doc_scales=doc_scales))
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

    # -- K2 at every seg_rows it takes against the plain version, and
    # pq_topk at seg_rows 16 against float64 ADC; times at seg_rows 16
    times_sr = {}
    for qp in PQ_SEG_QS:
        q = qrot[:qp].contiguous()
        lut = pq_lut(q, cbs).to(torch.bfloat16).contiguous()
        for sr in PQ_SEG_ROWS:
            got = pq_segmax(lut, codes_1m, sr)
            ref = pq_segmax_reference(lut, codes_1m, sr)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (qp, -(-N_PQ // sr)),
                  f"K2 seg_rows {sr} shape")
            err = float((got - ref).abs().max())
            check(err <= PQ_TOL, f"K2 seg_rows {sr} Q={qp} error {err}")
            max_err = max(max_err, err)
        k2 = lambda: pq_segmax(lut, codes_1m, 16)
        plain = lambda: pq_segmax_reference(lut, codes_1m, 16)
        p1, ka, kb, p2 = (time_ms(f) for f in (plain, k2, k2, plain))
        times_sr[qp] = {"k2_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                        "pq_topk_ms": time_ms(lambda: pq_topk(
                            q, codes_1m, cbs, 10, seg_rows=16))}
    q = qrot[:8].contiguous()
    s, i = pq_topk(q, codes_1m, cbs, 10, seg_rows=16)
    lut64 = torch.einsum("qmd,mcd->qmc", q.double().reshape(8, 2 * PQ_M, -1),
                         cbs.double())
    assert_topk_equiv_scores(torch, adc_scores64(torch, lut64, codes_1m),
                             10, s, i)

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
    return (max_err, times, recall, (t_data, t_train), times_w, times_sr,
            (docs, qs, cb, codes, ivf))


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



def phase_kernel_scripts(torch) -> dict:
    """The five kernel scripts of the evaluation slice at reduced size
    (SCRIPT_SIZES), 5 timed calls after 2 warm-ups a row:
    exp_rm_sweep (K1, K1-int8), exp_twophase_full (K4), bench_pq and
    exp_ivf_recovery (K2) on the card, exp_ivf_recovery_recall's numpy
    mirror on the host (its dispatch on the card). Returns their rows,
    the launches over exactly that run and the seconds."""
    from legal_rag_tpu_torch.scripts import (
        bench_pq, exp_ivf_recovery, exp_ivf_recovery_recall, exp_rm_sweep,
        exp_twophase_full,
    )

    def log(name):
        return lambda line: print(f"  {name}: {line}", flush=True)

    timing = dict(iters=5, warmup=2)
    n = SCRIPT_SIZES
    reset_counts()
    t0 = time.time()
    rows = {
        "exp_rm_sweep": exp_rm_sweep.run(n["exp_rm_sweep"], device="cuda",
                                         log=log("exp_rm_sweep"), **timing),
        "exp_twophase_full": exp_twophase_full.run(
            n["exp_twophase_full"], device="cuda",
            log=log("exp_twophase_full"), **timing),
        "bench_pq": bench_pq.run(n["bench_pq"], recall_docs=n["bench_pq"] // 4,
                                 device="cuda", log=log("bench_pq"), **timing),
        "exp_ivf_recovery": exp_ivf_recovery.run(
            n["exp_ivf_recovery"], device="cuda",
            log=log("exp_ivf_recovery"), **timing),
        "exp_ivf_recovery_recall": exp_ivf_recovery_recall.run(
            n["exp_ivf_recovery_recall"], device="cuda",
            log=log("exp_ivf_recovery_recall")),
    }
    torch.cuda.synchronize()
    counts = read_counts()
    secs = time.time() - t0
    for name in ("exp_rm_sweep", "exp_twophase_full"):
        for r in rows[name]:
            if "match" not in r:
                continue
            check(r["match"], f"{name} {r['name']}: top-10 differs from the "
                  f"flat select's")
            check("int8" in r["name"] or r["recall"] == 1.0,
                  f"{name} {r['name']}: recall@10 {r['recall']} against the "
                  f"flat select")
    for r in rows["exp_twophase_full"]:
        check(r["peak_extra_mb"] is not None, "exp_twophase_full memory")
    for r in rows["exp_ivf_recovery"]:
        check(0.0 <= r["recall"] <= 1.0 and r["ms"] is not None,
              f"exp_ivf_recovery {r['name']}: {r}")
        if r["oversample"] == RECOVERY_OVERSAMPLE:
            floor = RECOVERY_FLOOR["flat" if r["dispatch"] == "flat"
                                   else "ivf512"]
            check(r["recall"] >= floor, f"exp_ivf_recovery {r['name']}: "
                  f"recall@10 {r['recall']} < {floor}")
    for r in rows["exp_ivf_recovery_recall"]:
        check(r["overlap"] >= SCRIPT_OVERLAP, f"exp_ivf_recovery_recall "
              f"{r['dispatch']} x{r['oversample']}: the card's dispatch "
              f"returns {r['overlap']} of the mirror's candidates")
    for r in rows["bench_pq"]:
        # every row timed but the candidate recall's
        check("note" not in r and (r["ms"] is not None or r["name"].startswith(
            "candidate recall")), f"bench_pq {r['name']}")
        check(0.0 <= r.get("recall", 0.0) <= 1.0, f"bench_pq {r['name']}")
    check(sum(r["name"].startswith(("pq_topk sr=16", "K2 pq_segmax sr=16"))
              for r in rows["bench_pq"]) == 2, "bench_pq's seg_rows-16 rows")
    for kernel in ("K1", "K1-int8", "K2", "K4"):
        check(counts[kernel] > 0, f"the kernel scripts never launched "
              f"{kernel}: {counts}")
    return {"rows": rows, "counts": counts, "secs": secs}


def print_kernel_scripts(ks: dict) -> None:
    rows = ks["rows"]
    rm = rows["exp_rm_sweep"]
    best = min((r for r in rm if r["name"].startswith("rm ")),
               key=lambda r: r["ms"])
    print(f"phase 2i ok: the kernel scripts at reduced size ("
          + ", ".join(f"{k} N={v}" for k, v in SCRIPT_SIZES.items())
          + f"; the scripts' default is 2^20 or 1,000,000) in "
          f"{ks['secs']:.1f} s: exp_rm_sweep " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms" for r in rm)
          + f" (fastest two-phase: {best['name']}; every two-phase top-10 "
          f"== the flat select's, recall@10 1.0 but int8 "
          + f"{[r['recall'] for r in rm if 'int8' in r['name']][0]:.4f}); "
          f"exp_twophase_full " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms ({r['peak_extra_mb']:.1f} MB a "
              f"call)" for r in rows["exp_twophase_full"])
          + "; bench_pq " + ", ".join(
              f"{r['name']} " + ("untimed" if r["ms"] is None else
                                 f"{r['ms']:.4f} ms")
              + (f" recall {r['recall']:.4f}" if "recall" in r else "")
              for r in rows["bench_pq"])
          + "; exp_ivf_recovery at oversample 64: " + ", ".join(
              f"{r['dispatch']} {r['ms']:.4f} ms recall {r['recall']:.4f}"
              for r in rows["exp_ivf_recovery"]
              if r["oversample"] == RECOVERY_OVERSAMPLE)
          + "; exp_ivf_recovery_recall overlap with the card's dispatch >= "
          f"{min(r['overlap'] for r in rows['exp_ivf_recovery_recall']):.4f}"
          f"; launches K1 {ks['counts']['K1']}, K1-int8 "
          f"{ks['counts']['K1-int8']}, K2 {ks['counts']['K2']}, K4 "
          f"{ks['counts']['K4']}", flush=True)

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

    for kernel in (K1, K2, K3, K4, P, X1, X2):
        kernel.reset_counts()


def read_counts() -> dict:
    """Each kernel's launches since reset_counts: by its wrapper, plus
    those inside CUDA-graph replays (the served path replays captured
    programs, utils/graphs.py); the replays' share also on its own."""
    from legal_rag_tpu_torch.ops.argmax_probe import P
    from legal_rag_tpu_torch.ops.fused_topk import K3
    from legal_rag_tpu_torch.ops.mm_rowmax import X2
    from legal_rag_tpu_torch.ops.pq_segmax import K2
    from legal_rag_tpu_torch.ops.segmax_cm import K4
    from legal_rag_tpu_torch.ops.segmax_rm import K1
    from legal_rag_tpu_torch.ops.stream_probe import X1

    out = {}
    for name, kernel, counter in (
            ("K1", K1, "launches"), ("K1-int8", K1, "int8_launches"),
            ("K1 tensor cores", K1, "tensor_core_launches"),
            ("K2", K2, "launches"), ("K3", K3, "launches"),
            ("K4", K4, "launches"), ("P", P, "launches"),
            ("X1", X1, "launches"), ("X2", X2, "launches")):
        replays = kernel.in_replays[counter]
        out[name] = getattr(kernel, counter) + replays
        out[f"{name} in replays"] = replays
    return out


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
        sims = torch.einsum("qtd,bsd->qtbs", qt, mv.doc_tokens.full()[lo:hi].double())
        sims.masked_fill_(mv.doc_mask.full()[lo:hi][None, None] <= 0, -math.inf)
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
    _, cand = _local_dense_topc(q_emb, engine.index.docs.full(), 0, n_docs, c)
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
    slab = mv.doc_tokens.full()
    slab_gb = slab.numel() * slab.element_size() / 1e9
    return {
        "counts": rerank_counts, "stages": stages, "slab_gb": slab_gb,
        "block": block, "scan_ms": scan, "upload_s": t_upload,
        "profile": profile if device == "cuda" else None,
        "wall_s": time.time() - t0, "q": len(padded),
        "tq": int(q_tok.shape[1]),
    }


def device_breakdown(torch, fn, top: int = 4):
    """One call of ``fn`` under torch.profiler: ``(wall ms, device busy
    ms, the ``top`` kernels by device ms, the kernels launched)``; busy
    is None where the profiler records no device time. Both are read
    with the profiler on, which adds host cost to every launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, launches = [], 0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels.append((ev.key[:48], us / 1e3))
            launches += ev.count
    if not kernels:
        return wall, None, [], 0
    kernels.sort(key=lambda kv: -kv[1])
    return wall, sum(ms for _, ms in kernels), kernels[:top], launches


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
BUILD_ARGS = ("--finetune-steps", "100", "--finetune-token-weight", "0.5",
              "--pq-m", "48", "--ivf-cell-size", "256", "--rerank-steps",
              "100", "--multi-vector", "32")     # flag, value pairs
BUILD_SUBSET = 256      # chunks of the untrained card-vs-CPU build
ENCODE_DOCS = 16_384    # the encode throughput's corpus
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


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_ready(url: str, proc, what: str, timeout_s: float = 300) -> float:
    """Seconds until ``url``/health reports ready; fails when ``proc``
    exits first or the time runs out."""
    t0 = time.time()
    while True:
        check(proc.poll() is None, f"{what} exited {proc.returncode}")
        check(time.time() - t0 < timeout_s, f"{what} not ready in "
              f"{timeout_s} s")
        try:
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                if json.loads(r.read()).get("engine_status") == "ready":
                    return time.time() - t0
        except OSError:
            pass
        time.sleep(1)


def _serve_and_ask(store_dir: str, titles, device: str):
    """``python -m legal_rag_tpu_torch serve`` over the built store, in a
    process of its own: POST /api/v1/query per title and one
    /api/v1/batch_search of them all (k=10); the server is stopped
    before this returns. Returns (answers, batch rows, seconds to ready)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if "API_KEY" not in k}
    log = open(os.path.join(REPO_ROOT, "build", "smoke_serve.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "legal_rag_tpu_torch", "serve", "--store",
         store_dir, "--host", "127.0.0.1", "--port", str(port), "--device",
         device],
        cwd=REPO_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        ready_s = wait_ready(url, proc, "serve (see build/smoke_serve.log)")
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
    out["store_dir"] = store_dir

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
    out["tokenizer_impl"] = enc.tokenizer_impl
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
    print(f"phase 9 ok: tokenizer (host, {b['tokenizer_impl']}) "
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



EVAL_COMMANDS = (("eval", ("--include-paraphrase",)), ("eval-gate", ()),
                 ("eval-retrieval", ("--include-pq", "--include-maxsim")))
CI_FLOORS = {   # tests/test_quality_cli.py's untrained floors
    "structure": {"mode": "rrf", "recall@10": 0.88},
    "sibling": {"mode": "rrf", "recall@10": 0.40},
}
EVAL_CE_STEPS = 10      # a CE persisted on purpose for eval_ce_paraphrase
EVAL_SCRIPT_PAIRS = 100  # queries a split for the sparse and CE scripts
EVAL_BOOTSTRAP = 100


def _eval_command(cmd, flags, store_dir, report, device):
    """``python -m legal_rag_tpu_torch <cmd>`` in a process of its own;
    returns (exit code, seconds, stdout)."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "legal_rag_tpu_torch", cmd, "--store",
         store_dir, "--report", report, "--device", device, *flags],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=900,
    )
    check(out.returncode in (0, 1), f"{cmd} exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    return out.returncode, time.time() - t0, out.stdout


def phase_eval(store_dir: str, device: str = "cuda") -> dict:
    """The evaluation path over phase 9's store: ``eval
    --include-paraphrase``, ``eval-gate`` and ``eval-retrieval
    --include-pq --include-maxsim`` through the port's command line on
    ``device`` (each exit code as its report's gate says; provenance of
    the card), eval-retrieval's numbers against the CPU's within 2/n a
    split, K2's launches on the pq mode in process and its time at the
    eval's shape, the gate at the CI floors, and the four eval scripts
    (a copy of the store with a CE persisted for two of them)."""
    import shutil

    import numpy as np
    import torch

    from legal_rag_tpu_torch.config import DEFAULT_CONFIG
    from legal_rag_tpu_torch.evaluation import (
        evaluate_store, labeled_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.models.cross_encoder import (
        CrossEncoder, train_cross_encoder_hard,
    )
    from legal_rag_tpu_torch.ops.pq import pq_lut
    from legal_rag_tpu_torch.ops.pq_segmax import (
        pq_segmax, pq_segmax_reference,
    )
    from legal_rag_tpu_torch.quality import run_retrieval_gate
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine
    from legal_rag_tpu_torch.scripts import (
        diag_paraphrase, eval_ce_paraphrase, eval_fusion_policy,
        exp_paraphrase_sparse,
    )
    from legal_rag_tpu_torch.utils.timing import time_ms

    root = os.path.join(REPO_ROOT, "build", "smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = lambda name: os.path.join(root, f"{name}.json")
    out = {"commands": {}}
    t_phase = time.time()
    # eval-retrieval on the CPU, to compare with
    cpu_log = open(os.path.join(root, "cpu_eval_retrieval.log"), "w")
    cpu = subprocess.Popen(
        [sys.executable, "-m", "legal_rag_tpu_torch", "eval-retrieval",
         "--store", store_dir, "--report", report("cpu_eval-retrieval"),
         "--device", "cpu", *EVAL_COMMANDS[2][1]],
        cwd=REPO_ROOT, stdout=cpu_log, stderr=subprocess.STDOUT,
    )
    # the card's runs and the in-process work overlap the CPU's run
    try:
        for cmd, flags in EVAL_COMMANDS:
            rc, secs, stdout = _eval_command(cmd, flags, store_dir,
                                             report(cmd), device)
            with open(report(cmd)) as f:
                rep = json.load(f)
            out["commands"][cmd] = {"rc": rc, "s": secs, "stdout": stdout,
                                    "report": rep}
        cmds = out["commands"]
        ev = cmds["eval"]["report"]
        ok = ev["passed"] == ev["total"] and ev["paraphrase"]["gate_passed"]
        check(cmds["eval"]["rc"] == (0 if ok else 1),
              f"eval exit code {cmds['eval']['rc']} against its report")
        check(cmds["eval-gate"]["rc"] == (
            0 if cmds["eval-gate"]["report"]["gate_passed"] else 1),
            "eval-gate exit code against its report")
        check(cmds["eval-retrieval"]["rc"] == 0, "eval-retrieval exit code")
        want = (("gpu", torch.cuda.get_device_name(0)) if device == "cuda"
                else ("cpu", "cpu"))
        for cmd, c in cmds.items():
            prov = c["report"]["provenance"]
            check((prov["platform"], prov["device_kind"]) == want,
                  f"{cmd} provenance {prov}")
        # K2 on the eval path: the pq mode in this process, counted
        store = VectorStore.load(store_dir)
        pairs = labeled_pairs_from_chunks(store.chunks)
        reset_counts()
        evaluate_store(store, pairs, modes=("pq",), device=device)
        out["counts"] = read_counts()
        check(out["counts"]["K2"] > 0, f"the pq mode never launched K2: "
              f"{out['counts']}")
        # K2 at the eval's shape: a chunk of 256 queries, the probed cells
        eng = RetrievalEngine(store, device=device)
        ivf = store.ivf_index()
        probes = min(DEFAULT_CONFIG.dense.ivf_probes, ivf.n_cells)
        codes = torch.from_numpy(ivf.codes[:probes * ivf.cell_size]).to(device)
        q = eng.encoder.encode([p[0] for p in pairs[:256]])
        if store.pq_rotation is not None:       # OPQ: queries score rotated
            q = q @ np.asarray(store.pq_rotation, np.float32)
        q = torch.from_numpy(np.ascontiguousarray(q)).to(device)
        lut = pq_lut(q, torch.from_numpy(store.pq_codebooks).to(device))
        lut = lut.to(torch.bfloat16).contiguous()
        got, ref = pq_segmax(lut, codes), pq_segmax_reference(lut, codes)
        out["k2_err"] = float((got - ref).abs().max())
        check(out["k2_err"] <= PQ_TOL,
              f"K2 at the eval's shape: {out['k2_err']}")
        k2 = lambda: pq_segmax(lut, codes)
        plain = lambda: pq_segmax_reference(lut, codes)
        p1, ka, kb, p2 = (time_ms(f) for f in (plain, k2, k2, plain))
        nq, nc, m = q.shape[0], codes.shape[0], codes.shape[1]
        out["k2"] = {"q": nq, "n": nc, "m": m, "ms": (ka + kb) / 2,
                     "plain_ms": (p1 + p2) / 2,
                     "bound": bound(nc * m + nq * 2 * m * 16 * 2
                                    + nq * (-(-nc // 8)) * 4,
                                    nq * nc * 2 * m, "fp32")}

        # the gate at the untrained CI floors, in process on the card
        gate = run_retrieval_gate(store, thresholds=CI_FLOORS, engine=eng,
                                  device=device)
        check(gate["gate_passed"] == all(c["passed"] for c in gate["checks"]),
              "gate verdict")
        out["ci_gate"] = gate

        # the eval scripts; a CE persisted on purpose on a copy of the store
        t0 = time.time()
        ce_dir = os.path.join(root, "store_ce")
        shutil.copytree(store_dir, ce_dir)
        ce_store = VectorStore.load(ce_dir)
        ce = CrossEncoder(RetrievalEngine(ce_store, device=device).encoder)
        train_cross_encoder_hard(ce, [c["text"] for c in ce_store.chunks],
                                 chunks=ce_store.chunks, steps=EVAL_CE_STEPS)
        ce_store.ce_params, ce_store.ce_alpha = ce.params, 0.1
        ce_store.save(ce_dir)
        out["ce_s"] = time.time() - t0
        quiet = lambda line: None
        scripts = {}
        for name, fn in (
            ("diag_paraphrase", lambda: diag_paraphrase.run(
                ce_dir, device=device, log=quiet)),
            ("eval_fusion_policy", lambda: eval_fusion_policy.run(
                store, bootstrap=EVAL_BOOTSTRAP, engine=eng, log=quiet)),
            ("exp_paraphrase_sparse", lambda: exp_paraphrase_sparse.run(
                store.chunks, max_pairs=EVAL_SCRIPT_PAIRS, log=quiet)),
            ("eval_ce_paraphrase", lambda: eval_ce_paraphrase.run(
                VectorStore.load(ce_dir), n=EVAL_SCRIPT_PAIRS, device=device,
                log=quiet)),
        ):
            t0 = time.time()
            scripts[name] = (fn(), time.time() - t0)
        diag = scripts["diag_paraphrase"][0]
        check(sum(diag["summary"].values()) == 10, f"diag {diag['summary']}")
        check(scripts["eval_fusion_policy"][0]["provenance"]["platform"]
              == want[0], "eval_fusion_policy provenance")
        out["scripts"] = scripts
        t0 = time.time()
        check(cpu.wait(timeout=900) == 0, "eval-retrieval on the CPU "
              "failed; see build/smoke_eval/cpu_eval_retrieval.log")
        out["cpu_wait_s"] = time.time() - t0
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait(timeout=30)
        cpu_log.close()
    with open(report("cpu_eval-retrieval")) as f:
        cpu_rep = json.load(f)
    card_rep = cmds["eval-retrieval"]["report"]
    diffs = {}
    for split in ("structure", "paraphrase"):
        n = card_rep[split]["n_queries"]
        check(cpu_rep[split]["n_queries"] == n, f"{split} query count")
        for mode, m in card_rep[split]["modes"].items():
            for metric in ("recall@10", "mrr"):
                d = abs(m[metric] - cpu_rep[split]["modes"][mode][metric])
                check(d <= 2 / n, f"eval-retrieval {split}/{mode} {metric}: "
                      f"card {m[metric]} vs CPU "
                      f"{cpu_rep[split]['modes'][mode][metric]} (n={n})")
                diffs[(split, mode, metric)] = d
    out["max_diff"] = max(diffs.values())
    out["n_queries"] = {s: card_rep[s]["n_queries"]
                        for s in ("structure", "paraphrase")}
    out["wall_s"] = time.time() - t_phase
    return out


def print_eval(e: dict) -> None:
    """Phase 10's lines, from what ``phase_eval`` returns."""
    for cmd, c in e["commands"].items():
        table = [ln for ln in c["stdout"].splitlines()
                 if ln.strip() and not ln.startswith("report ->")]
        print(f"phase 10: {cmd} exit {c['rc']} in {c['s']:.1f} s: "
              + " | ".join(ln.strip() for ln in table), flush=True)
    prov = e["commands"]["eval-retrieval"]["report"]["provenance"]
    print("phase 10: provenance " + json.dumps(prov, sort_keys=True),
          flush=True)
    gate = e["ci_gate"]
    scripts = e["scripts"]
    fp = scripts["eval_fusion_policy"][0]["splits"]
    sp = scripts["exp_paraphrase_sparse"][0]["splits"]
    ce = scripts["eval_ce_paraphrase"][0]["splits"]
    print(f"phase 10 ok: eval, eval-gate and eval-retrieval on the card "
          f"(provenance gpu, {prov['device_kind']}), exit codes as their "
          f"reports' gates; eval-retrieval ({e['n_queries']}) == the CPU's "
          f"within 2/n (max diff {e['max_diff']:.4g}; waited "
          f"{e['cpu_wait_s']:.1f} s for the CPU's run); K2 launched "
          f"{e['counts']['K2']}x by the pq mode in process, and at the "
          f"eval's shape (Q={e['k2']['q']}, {e['k2']['n']} codes of "
          f"m={e['k2']['m']}) == plain within {PQ_TOL} (max abs err "
          f"{e['k2_err']:.3g}): K2 {e['k2']['ms']:.4f} ms, plain "
          f"{e['k2']['plain_ms']:.4f} ms, bound {e['k2']['bound'][0]:.4f} ms; "
          f"the gate at the CI floors: " + ", ".join(
              f"{c['name']} {c['mode']} {c['metric']} {c['measured']:.4f} "
              f"(floor {c['threshold']})" for c in gate["checks"])
          + f" -> {'PASS' if gate['gate_passed'] else 'FAIL'}; phase wall "
          f"{e['wall_s']:.1f} s (CE of {EVAL_CE_STEPS} steps persisted on a "
          f"copy in {e['ce_s']:.1f} s)", flush=True)
    print(f"phase 10 ok: the eval scripts on the card: diag_paraphrase "
          f"({scripts['diag_paraphrase'][1]:.1f} s) "
          f"{scripts['diag_paraphrase'][0]['summary']}; eval_fusion_policy "
          f"(bootstrap {EVAL_BOOTSTRAP}, {scripts['eval_fusion_policy'][1]:.1f}"
          f" s) " + "; ".join(
              f"{split} r@10 " + ", ".join(
                  f"{mode} {fp[split]['modes'][mode]['recall@10']}"
                  for mode in ("rrf", "dense", "policy_union"))
              for split in fp)
          + f"; exp_paraphrase_sparse ({EVAL_SCRIPT_PAIRS} a split, "
          f"{scripts['exp_paraphrase_sparse'][1]:.1f} s) " + "; ".join(
              f"{split} r@10 " + ", ".join(
                  f"{mode} {v['recall@10']}" for mode, v in
                  list(sp[split]["modes"].items())[:3])
              for split in sp)
          + f"; eval_ce_paraphrase (n={EVAL_SCRIPT_PAIRS}, "
          f"{scripts['eval_ce_paraphrase'][1]:.1f} s) " + "; ".join(
              f"{split} base MRR {v['base']['mrr']:.4f}, best alpha "
              f"{v['best_alpha']} MRR "
              f"{v['alphas'][str(v['best_alpha'])]['mrr']:.4f}"
              for split, v in ce.items()), flush=True)

# phase 11: the build of phase 9's corpus and its stage seconds with the
# Python tokenizer (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5)
PYTHON_TOKENIZER_BUILD = ("61.3 s; build stages (s): ingest 0.021, finetune "
                          "20.135, encode 3.108, tokens 2.829, pq 0.531, ivf "
                          "0.011, bm25 0.427, rerank 29.209, save 3.075")
# tests/test_native.py's adversarial inputs, and its full-Unicode fuzz
# (native_fuzz_texts)
NATIVE_ADVERSARIAL = (
    "", "   ", "Hello, World!", "Café résumé naïve Łódź",
    "§183 — the 'said' provision… (a) [b] {c}",
    "word\u00adwith\u200bformat\u200cchars", "CJK 中文 mixed 漢字 text",
    "x" * 250,
    "UPPER lower MiXeD 123 45.67", "tabs\tand\nnewlines\r\nand  spaces",
    "em—dash–hyphen-minus", "धारा १७३ के अनुसार। दंड प्रक्रिया।",
    "İstanbul'da İĞNE ve ışık", "ΝΟΜΟΣ ΠΟΙΝΙΚΟΣ: Ο Σ ΣΤΟ ΤΕΛΟΣ",
    "ΟΔΥΣΣΕΥΣ ΟΔΥΣΣΕΥΣΑ 'ΣΟΦΟΣ' (ΣΟΦΟΣ)", "УГОЛОВНЫЙ КОДЕКС статья",
    "ʼn ǅungla ǲur ﬁne ﬂow", "áé combining, ﬀ ligature",
    "豈 更 車 compatibility ideographs", "１２３ ＡＢＣ ｆｕｌｌｗｉｄｔｈ！？",
)
HYB_N = 1_000_000   # bench_hybrid_scale's docs: K1's two-phase path
# few requests a client: the three servers' start-up already takes most of
# the phase, and the whole smoke must stay well inside 1,200 s
HTTP_ARGS = {"requests": 2, "levels": (1, 16), "no_coalesce_pass": True,
             "no_rerank_pass": True}


def native_fuzz_texts():
    """300 random strings over 600 printable code points from all of
    Unicode, some with a final sigma (tests/test_native.py's sweep)."""
    import random
    import unicodedata

    rng = random.Random(7)
    pool = []
    while len(pool) < 600:
        ch = chr(rng.randrange(0x20, 0x2FA20))
        if not unicodedata.category(ch).startswith("C"):
            pool.append(ch)
    out = []
    for _ in range(300):
        t = "".join(rng.choice(pool) for _ in range(rng.randrange(1, 30)))
        if rng.random() < 0.3:
            t = t.replace(t[rng.randrange(len(t))], "Σ")
        out.append(t)
    return out


def phase_native(b: dict) -> dict:
    """The C++ tokenizer on the card's host: built by g++ from the
    port's copy, recorded by phase 9's build (``native-cpp``, or the
    run fails), ids equal to the Python tokenizer's on every chunk and
    every adversarial and fuzz input, and both tokenizers' docs/s."""
    from legal_rag_tpu_torch import native_ext
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    out = {}
    t0 = time.time()
    check(native_ext.build_native(), "g++ did not build the native "
          f"tokenizer; see {native_ext.library_path().parent / 'g++.log'}")
    out["build_s"] = time.time() - t0
    out["library"] = os.path.relpath(native_ext.library_path(), REPO_ROOT)
    check(out["library"].startswith("build" + os.sep), "library outside build/")
    store = VectorStore.load(b["store_dir"])
    out["impl"] = store.encoder_info.get("tokenizer_impl")
    check(out["impl"] == "native-cpp", f"phase 9's store records the "
          f"tokenizer {out['impl']!r}, not native-cpp")
    py = WordPieceTokenizer(store.wp_vocab)
    cc = native_ext.NativeWordPiece(store.wp_vocab)
    texts = [c["text"] for c in store.chunks]
    max_len = int(store.encoder_info["max_len"])
    ids = {}
    for name, tok in (("python", py), ("native-cpp", cc)):
        t0 = time.time()
        ids[name] = [tok.encode(t, max_len=max_len) for t in texts]
        out[f"{name}_docs_s"] = len(texts) / (time.time() - t0)
    check(ids["python"] == ids["native-cpp"], "native ids != Python ids on "
          "the corpus")
    odd = list(NATIVE_ADVERSARIAL) + native_fuzz_texts()
    for t in odd:
        check(cc.encode(t, max_len=64) == py.encode(t, max_len=64),
              f"native ids != Python ids on {t!r}")
    out["n_chunks"], out["n_odd"] = len(texts), len(odd)
    return out


def print_native(nat: dict, b: dict) -> None:
    print(f"phase 11 ok: native tokenizer built by g++ from "
          f"legal_rag_tpu_torch/native/wordpiece.cpp in {nat['build_s']:.2f} s"
          f" into {nat['library']}; phase 9's store records tokenizer_impl "
          f"{nat['impl']}; ids == the Python tokenizer's on all "
          f"{nat['n_chunks']} chunks and {nat['n_odd']} adversarial and fuzz "
          f"inputs; docs/s (host, max_len 256): native-cpp "
          f"{nat['native-cpp_docs_s']:.0f}, python {nat['python_docs_s']:.0f};"
          f" phase 9's build with it: {b['build_s']:.1f} s; {b['stages']} "
          f"(with the Python tokenizer: {PYTHON_TOKENIZER_BUILD})", flush=True)


def phase_benches(b: dict, device: str = "cuda", n: int = HYB_N) -> dict:
    """bench_hybrid_scale at ``n`` docs (K1 on its dense stage, counted)
    and bench_http over phase 9's store on ``device``."""
    import numpy as np
    import torch

    from legal_rag_tpu_torch.scripts import bench_http, bench_hybrid_scale

    out = {}
    t0 = time.time()
    reset_counts()
    hyb = bench_hybrid_scale.run(
        n, device=device,
        log=lambda line: print(f"phase 12: {line}", flush=True))
    out["counts"] = read_counts()
    out["hybrid_s"] = time.time() - t0
    check(device == "cpu" or (out["counts"]["K1"] > 0
                              and hyb["k1_launches"] > 0),
          f"bench_hybrid_scale never launched K1: {out['counts']}")
    for key in ("sparse_recall", "overlap"):
        check(math.isfinite(hyb[key]) and 0.0 <= hyb[key] <= 1.0,
              f"bench_hybrid_scale {key} {hyb[key]}")
    for name, (f, ids) in hyb["hybrid"].items():
        check(f.shape == ids.shape == (bench_hybrid_scale.Q,
                                       bench_hybrid_scale.K)
              and bool(np.isfinite(f).all()),
              f"bench_hybrid_scale {name} output")
    out["hybrid"] = {k: hyb[k] for k in ("n", "nnz", "budgets", "gather_ms",
                                         "sparse_recall", "hybrid_ms",
                                         "overlap", "k1_launches")}
    del hyb
    torch.cuda.empty_cache()

    t0 = time.time()
    log_path = os.path.join(REPO_ROOT, "build", "smoke_bench_http.log")
    report = bench_http.run(
        b["store_dir"], port=free_port(), device=device,
        log=lambda line: print(f"phase 12: bench_http {line}", flush=True),
        server_log=log_path, **HTTP_ARGS)
    out["http_s"] = time.time() - t0
    for name, rows in report["passes"].items():
        for row in rows:
            check(row["n_errors"] == 0 and row["n_requests"] == (
                HTTP_ARGS["requests"] * row["concurrency"]),
                f"bench_http {name} c={row['concurrency']}: "
                f"{row.get('error_sample')} (log {log_path})")
    check(len(report["passes"]) == 3, f"bench_http passes {report['passes']}")
    check(report["provenance"]["platform"] == (
        "cpu" if device == "cpu" else "gpu"), "bench_http provenance")
    out["http"] = report
    return out


def print_benches(bn: dict) -> None:
    h = bn["hybrid"]
    print(f"phase 12 ok: bench_hybrid_scale at N={h['n']} (nnz {h['nnz']}, "
          f"bf16 docs, Q=64, k=10, c=20, w=0.5) in {bn['hybrid_s']:.1f} s: "
          f"hybrid ms a batch of 64 (median, CUDA events) capped "
          f"{h['hybrid_ms']['capped']:.4f} (budget {h['budgets']['capped']}),"
          f" uncapped {h['hybrid_ms']['uncapped']:.4f} (budget "
          f"{h['budgets']['uncapped']}); host gather ms capped "
          f"{h['gather_ms']['capped']:.1f}, uncapped "
          f"{h['gather_ms']['uncapped']:.1f}; capped sparse recall@10 "
          f"{h['sparse_recall']:.4f}, hybrid top-10 overlap capped vs "
          f"uncapped {h['overlap']:.4f}; K1 launched {h['k1_launches']}x "
          f"({bn['counts']['K1 tensor cores']}x on the tensor cores)",
          flush=True)
    rep = bn["http"]
    print(f"phase 12 ok: bench_http over phase 9's store in "
          f"{bn['http_s']:.1f} s ({HTTP_ARGS['requests']} requests a client;"
          f" provenance {json.dumps(rep['provenance'], sort_keys=True)}), "
          "zero errors: " + "; ".join(
              f"{name} c={r['concurrency']}: p50 {r['p50_ms']} ms, p99 "
              f"{r['p99_ms']} ms, {r['qps']} qps"
              for name, rows in rep["passes"].items() for r in rows),
          flush=True)


def phase_entry_points(b: dict, names=("start_torch.sh",
                                        "spaces_app_torch.py"),
                       device: str = "cuda") -> dict:
    """``start_torch.sh`` and ``spaces_app_torch.py`` (the one serves on
    ``device``, the other on the card) over phase 9's store, each in a
    process group of its own: ready on /health, one /api/v1/query
    answered 200, then SIGTERM to the group."""
    import signal

    out = {}
    cmds = {"start_torch.sh": ["bash", os.path.join(REPO_ROOT, "start_torch.sh")],
            "spaces_app_torch.py": [sys.executable, os.path.join(
                REPO_ROOT, "spaces_app_torch.py")]}
    for name in names:
        cmd = cmds[name]
        port = free_port()
        env = {k: v for k, v in os.environ.items() if "API_KEY" not in k}
        env.update(LEGAL_RAG_STORE=b["store_dir"], PORT=str(port),
                   PYTHON=sys.executable, LEGAL_RAG_DEVICE=device)
        log_path = os.path.join(REPO_ROOT, "build", f"smoke_{name}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, cwd=REPO_ROOT, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        url = f"http://127.0.0.1:{port}"
        try:
            ready = wait_ready(url, proc, f"{name} (log {log_path})")
            t0 = time.time()
            body = post(url + "/api/v1/query", {"query": PROCEDURAL})
            check(bool(body.get("context_used")), f"{name}: empty context")
            out[name] = {"ready_s": ready, "query_s": time.time() - t0}
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
        out[name]["rc"] = proc.returncode
    return out


def print_entry_points(ep: dict) -> None:
    print("phase 13 ok: " + "; ".join(
        f"{name} over phase 9's store ready in {e['ready_s']:.1f} s, "
        f"/api/v1/query answered 200 in {e['query_s']:.2f} s, stopped by "
        f"SIGTERM to its process group (exit {e['rc']})"
        for name, e in ep.items()), flush=True)


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


# -- 14. multi-GPU sharding on the one card ---------------------------------

SHARD_Q = 64                 # the coalescer's flush
N_MV_SHARDED = 65_536        # the MaxSim slab's depth at S=2
FT_STEPS, FT_BATCH = 3, 32   # the fine-tune's steps and global batch
FT_RTOL = 1e-4               # S=2 vs S=1 losses: fp32 sums in another order
SEG_ODD = (3, 12)            # K2 at seg_rows that are not powers of two

SHARD_WORKER = r'''
import json, os, sys, time
sys.path.insert(0, os.environ["LR_REPO"])
import numpy as np
import torch
import torch.distributed as dist
from legal_rag_tpu_torch.parallel import mesh as pm

n_proc, pid = int(os.environ["LR_NPROC"]), int(os.environ["LR_PID"])
backend = os.environ["LR_BACKEND"]
pm.initialize_distributed(os.environ["LR_COORD"], n_proc, pid, [0],
                          device="cuda", backend=backend)
from legal_rag_tpu_torch.ops.segmax_rm import K1
from legal_rag_tpu_torch.parallel.sharded import (
    ShardedIndex, sharded_hybrid_search,
)
from legal_rag_tpu_torch.utils.timing import time_ms

dev = torch.device("cuda", 0)
out = {"process": pid, "world": dist.get_world_size(), "backend": backend}
# does the process group take CUDA tensors for all_gather as they are?
try:
    parts = [torch.empty(4, device=dev) for _ in range(n_proc)]
    dist.all_gather(parts, torch.ones(4, device=dev))
    torch.cuda.synchronize()
    out["cuda_all_gather"] = "taken"
except Exception as exc:  # noqa: BLE001 - reported, not hidden
    out["cuda_all_gather"] = f"refused: {type(exc).__name__}"
inp = np.load(os.environ["LR_IN"])
emb = np.load(os.path.join(os.environ["LR_STORE"], "embeddings.npy"),
              mmap_mode="r")
mesh = pm.make_mesh(n_proc)
t0 = time.time()
index = ShardedIndex.from_embeddings(emb, mesh)
torch.cuda.synchronize()
out["upload_s"] = time.time() - t0
args = [torch.from_numpy(inp[k]).to(dev) for k in ("pid", "pw", "q", "w")]
res = {}
for mode in ("rrf", "weighted"):
    K1.launches = 0
    f, ids, _, _ = sharded_hybrid_search(
        index.docs, *args, mesh=mesh, k=10, c=20, n_docs=int(inp["n"]),
        mode=mode)
    torch.cuda.synchronize()
    res[mode + "_f"], res[mode + "_i"] = f.cpu().numpy(), ids.cpu().numpy()
    out[mode + "_k1"] = K1.launches
out["search_ms"] = time_ms(lambda: sharded_hybrid_search(
    index.docs, *args, mesh=mesh, k=10, c=20, n_docs=int(inp["n"]),
    mode="rrf"), iters=5, warmup=1)
cand = {(0, s): torch.zeros(args[2].shape[0], 20, device=dev)
        for s in range(n_proc) if mesh.is_local((s,))}
owners = {(0, s): s for s in range(n_proc)}
out["gather_ms"] = time_ms(
    lambda: pm.gather_items(mesh, cand, owners, dev), iters=20, warmup=2)
np.savez(os.environ["LR_OUT"], **res)
pm.shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
'''


def same_topk(torch, f_a, i_a, f_b, i_b, tol, what):
    """Two ``[Q, k]`` results equal under the tie rule: values rank by
    rank within ``tol``; where ids differ, the ranks' values tie."""
    check(f_a.shape == f_b.shape, f"{what}: shapes {f_a.shape} {f_b.shape}")
    fa, fb = f_a.double().cpu(), f_b.double().cpu()
    fin = torch.isfinite(fa)
    check(bool((fin == torch.isfinite(fb)).all()), f"{what}: finite slots "
          "differ")
    gap = float((fa - fb)[fin].abs().max()) if bool(fin.any()) else 0.0
    check(gap <= tol, f"{what}: values differ by {gap}")
    ia, ib = i_a.cpu(), i_b.cpu()
    for qi in range(ia.shape[0]):
        row_a, row_b = ia[qi].tolist(), ib[qi].tolist()
        if row_a == row_b:
            continue
        kth = float(fa[qi, -1])
        clear_a = {d for d, v in zip(row_a, fa[qi].tolist()) if v > kth + tol}
        clear_b = {d for d, v in zip(row_b, fb[qi].tolist()) if v > kth + tol}
        check(clear_a == clear_b, f"{what}: query {qi}: {row_a} vs {row_b}")
    return int((ia != ib).sum())


def run_shard_workers(torch, store_dir: str, inputs: dict) -> dict:
    """The two-process gloo run (two processes on cuda:0, world 2) and
    the one-process NCCL run (world 1), at once, each a process of its
    own; returns their reports and results."""
    import numpy as np

    work = os.path.join(REPO_ROOT, "build", "smoke_shards")
    os.makedirs(work, exist_ok=True)
    in_path = os.path.join(work, "inputs.npz")
    np.savez(in_path, **inputs)
    runs = {"gloo": 2, "nccl": 1}
    procs = []
    for backend, n_proc in runs.items():
        port = free_port()
        for pid in range(n_proc):
            env = dict(os.environ, LR_REPO=REPO_ROOT, LR_NPROC=str(n_proc),
                       LR_PID=str(pid), LR_BACKEND=backend,
                       LR_COORD=f"localhost:{port}", LR_IN=in_path,
                       LR_STORE=store_dir,
                       LR_OUT=os.path.join(work, f"{backend}{pid}.npz"))
            log = open(os.path.join(work, f"{backend}{pid}.log"), "w")
            procs.append((backend, pid, log, subprocess.Popen(
                [sys.executable, "-c", SHARD_WORKER], env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)))
    out = {}
    try:
        for backend, pid, log, p in procs:
            rc = p.wait(timeout=240)
            log.close()
            text = open(log.name).read()
            check(rc == 0, f"{backend} worker {pid} exited {rc}: {text[-3000:]}")
            line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            check(bool(line), f"{backend} worker {pid}: no result")
            rep = json.loads(line[-1][len("RESULT "):])
            rep["res"] = dict(np.load(os.path.join(work, f"{backend}{pid}.npz")))
            out[(backend, pid)] = rep
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def phase_shards(store, engine, recovery, seed: int) -> dict:
    """Phase 14: the sharded paths on the one card (every mesh position
    on cuda:0), each against its one-shard run and a float64 reference."""
    import collections

    import numpy as np
    import torch

    from legal_rag_tpu_torch.models.finetune import finetune_encoder
    from legal_rag_tpu_torch.ops.dense import TWOPHASE_MIN_DOCS, exact_rescore
    from legal_rag_tpu_torch.ops.pq import pq_lut, pq_topk
    from legal_rag_tpu_torch.ops.pq_segmax import (
        K2, pq_segmax, pq_segmax_reference,
    )
    from legal_rag_tpu_torch.ops.segmax_rm import (
        segmax_rm, segmax_rm_reference,
    )
    from legal_rag_tpu_torch.parallel.mesh import Mesh, make_mesh
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, ShardedMultiVectorIndex, _Work, _local_dense_topc,
        sharded_hybrid_search,
    )
    from legal_rag_tpu_torch.retrieval.engine import _pad_pow2
    from legal_rag_tpu_torch.utils.timing import time_ms

    t_phase = time.time()
    dev = torch.device("cuda", 0)
    one = make_mesh(1)
    check(engine.mesh.shape == {"shard": 1}, "the served engine is not S=1")
    mesh = {s: Mesh([dev] * s, ("shard",)) for s in (2, 4)}
    cfg = engine.config
    out = {"counts": {}, "ms": {}, "gather_ms": {}, "swaps": {}}
    Row = collections.namedtuple("Row", "doc_id score")

    # -- 14a. S=2 over the fp32 store: RRF and weighted, against S=1 and
    # the float64 channels
    queries = SERVED_BATCHES[SHARD_Q]
    q_emb = engine.encoder.encode(list(queries))
    budget = _pad_pow2(store.bm25.postings_budget(
        queries, cap=cfg.bm25.postings_budget_cap))
    pid_np, pw_np = store.bm25.gather_postings(queries, budget)
    w_np = np.full(SHARD_Q, cfg.fusion.hybrid_weight, np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pid_np, pw_np, q_emb, w_np)]
    n = store.n_docs
    t0 = time.time()
    idx2 = ShardedIndex.from_embeddings(store.embeddings, mesh[2])
    torch.cuda.synchronize()
    out["upload_s"] = time.time() - t0
    n_local = idx2.docs.shape[0] // 2
    out["n_local"] = n_local
    check(n_local >= TWOPHASE_MIN_DOCS, f"n_local {n_local} takes no K1")
    # K1 at one shard's shape against its plain version
    blk, qf = idx2.docs.local((0,)), args[2].float().contiguous()
    got = segmax_rm(qf, blk, n_local)
    ref = segmax_rm_reference(qf, blk, n_local)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= SEG_TOL, f"K1 at a shard: error {err}")
    p1, ka, kb, p2 = (time_ms(f, iters=10, warmup=2) for f in (
        lambda: segmax_rm_reference(qf, blk, n_local),
        lambda: segmax_rm(qf, blk, n_local),
        lambda: segmax_rm(qf, blk, n_local),
        lambda: segmax_rm_reference(qf, blk, n_local)))
    out["k1_shard"] = {
        "ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2, "err": err,
        "bound": bound(n_local * DIM * 4 + SHARD_Q * DIM * 4
                       + SHARD_Q * n_local // 8 * 4,
                       3 * 2 * SHARD_Q * n_local * DIM, "tf32")}
    channels = channel_scores(store, engine.encoder, queries,
                              cfg.bm25.postings_budget_cap, False)
    c = max(cfg.fusion.candidate_multiplier * 10, 10)
    res = {}
    for mode in ("rrf", "weighted"):
        reset_counts()
        f2, i2, _, _ = sharded_hybrid_search(
            idx2.docs, *args, mesh=mesh[2], k=10, c=c, n_docs=n, mode=mode)
        torch.cuda.synchronize()
        out["counts"][f"S=2 {mode}"] = read_counts()
        check(read_counts()["K1"] == 2, f"S=2 {mode}: K1 launched "
              f"{read_counts()['K1']}x, not once a shard")
        f1, i1, _, _ = sharded_hybrid_search(
            engine.index.docs, *args, mesh=engine.mesh, k=10, c=c, n_docs=n,
            mode=mode)
        out["swaps"][f"S=2 {mode}"] = same_topk(
            torch, f2, i2, f1, i1, DENSE_TOL + RRF_SWAP * (mode == "rrf"),
            f"S=2 vs S=1 {mode}")
        for qi in range(SHARD_Q):
            rows = [Row(int(d), float(v)) for d, v in
                    zip(i2[qi].tolist(), f2[qi].tolist())]
            assert_rows_exact(rows, channels[qi], mode, float(w_np[qi]), c,
                              cfg.fusion.rrf_k, f"S=2 {mode}")
        res[mode] = (f2, i2, f1, i1)
        for s, m, idx in ((1, engine.mesh, engine.index), (2, mesh[2], idx2)):
            out["ms"][(mode, s)] = time_ms(lambda: sharded_hybrid_search(
                idx.docs, *args, mesh=m, k=10, c=c, n_docs=n, mode=mode),
                iters=10, warmup=2)

    # the candidates' gather alone (the reference's all_gather), S = 2, 4
    for s in (2, 4):
        work = _Work(mesh[s], None, SHARD_Q)
        items = {(0, j): torch.randn(SHARD_Q, c, device=dev)
                 for j in range(s)}
        out["gather_ms"][s] = time_ms(
            lambda: work.to_qc(work.gather(items), 0), iters=50, warmup=5)

    # -- 14b. a 2x2 (data, shard) mesh: the batch split over rows
    mesh22 = Mesh([[dev, dev], [dev, dev]], ("data", "shard"))
    idx22 = ShardedIndex.from_embeddings(store.embeddings, mesh22)
    for mode in ("rrf", "weighted"):
        reset_counts()
        f22, i22, _, _ = sharded_hybrid_search(
            idx22.docs, *args, mesh=mesh22, k=10, c=c, n_docs=n, mode=mode,
            data_axis="data")
        torch.cuda.synchronize()
        check(read_counts()["K1"] == 4, "2x2: K1 not once a position")
        f2, i2, _, _ = res[mode]
        out["swaps"][f"2x2 {mode}"] = same_topk(
            torch, f22, i22, f2, i2, DENSE_TOL + RRF_SWAP * (mode == "rrf"),
            f"2x2 vs S=2 {mode}")
    del idx22
    torch.cuda.empty_cache()

    # -- 14c. the two-process gloo run and the one-process NCCL run over
    # the saved store, against this process's S=2 and S=1
    workers = run_shard_workers(torch, os.path.join(REPO_ROOT, "build",
                                                    "smoke_store"), {
        "pid": pid_np, "pw": pw_np, "q": np.ascontiguousarray(q_emb),
        "w": w_np, "n": np.int64(n)})
    for (backend, pid), rep in workers.items():
        for mode in ("rrf", "weighted"):
            f2, i2, f1, i1 = res[mode]
            f_ref, i_ref = (f2, i2) if backend == "gloo" else (f1, i1)
            same_topk(torch, torch.from_numpy(rep["res"][mode + "_f"]),
                      torch.from_numpy(rep["res"][mode + "_i"]), f_ref, i_ref,
                      DENSE_TOL + RRF_SWAP * (mode == "rrf"),
                      f"{backend} process {pid} {mode}")
            check(rep[mode + "_k1"] == 1, f"{backend} process {pid}: K1 "
                  f"launched {rep[mode + '_k1']}x")
    out["workers"] = {k: {n_: v for n_, v in rep.items() if n_ != "res"}
                      for k, rep in workers.items()}
    del idx2
    torch.cuda.empty_cache()

    # -- 14d. PQ at S=4 over the recovery workload: flat against S=1, K2
    # once a shard; IVF at 512 probes a shard above the recall floor
    docs, qs, cb, codes, ivf = recovery
    k, kk = 10, 10 * RECOVERY_OVERSAMPLE
    qrot = torch.from_numpy(np.ascontiguousarray(cb.rotate(qs))).to(dev)
    no_pid = torch.full((RECOVERY_Q, 8), RECOVERY_N, dtype=torch.int32,
                        device=dev)
    no_w = torch.zeros((RECOVERY_Q, 8), device=dev)
    zero = torch.zeros(RECOVERY_Q, device=dev)
    gold = torch.from_numpy(qs).to(dev) @ torch.from_numpy(docs).to(dev).T
    gold = [set(r) for r in torch.sort(gold, dim=1, descending=True,
                                       stable=True).indices[:, :k].tolist()]
    pq_idx = {s: ShardedIndex.from_pq(codes, cb.codebooks, m, cb.rotation)
              for s, m in ((1, one), (4, mesh[4]))}
    flat = {}
    for s, m in ((1, one), (4, mesh[4])):
        K2.launches = 0
        f, i, _, _ = sharded_hybrid_search(
            pq_idx[s].docs, no_pid, no_w, qrot, zero, None,
            pq_idx[s].pq_codebooks, mesh=m, k=kk, c=kk, n_docs=RECOVERY_N)
        torch.cuda.synchronize()
        out["counts"][f"pq S={s}"] = K2.launches
        check(K2.launches == s, f"PQ S={s}: K2 launched {K2.launches}x")
        flat[s] = (f, i)
    out["swaps"]["pq flat S=4"] = same_topk(torch, *flat[4], *flat[1], PQ_TOL,
                                            "PQ flat S=4 vs S=1")
    # K2 at one shard's shape against its plain version
    blk = pq_idx[4].docs.local((0,))
    lut = pq_lut(qrot, pq_idx[4].pq_codebooks.local((0,))).to(
        torch.bfloat16).contiguous()
    got, ref = pq_segmax(lut, blk), pq_segmax_reference(lut, blk)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= PQ_TOL, f"K2 at a shard: error {err}")
    p1, ka, kb, p2 = (time_ms(f, iters=10, warmup=2) for f in (
        lambda: pq_segmax_reference(lut, blk), lambda: pq_segmax(lut, blk),
        lambda: pq_segmax(lut, blk), lambda: pq_segmax_reference(lut, blk)))
    n_blk = blk.shape[0]
    out["k2_shard"] = {
        "ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2, "err": err,
        "rows": n_blk,
        "bound": bound(n_blk * PQ_M + RECOVERY_Q * 2 * PQ_M * 16 * 2
                       + RECOVERY_Q * n_blk // 8 * 4,
                       RECOVERY_Q * n_blk * 2 * PQ_M, "fp32")}
    ivf_idx = ShardedIndex.from_pq_ivf(ivf, cb.codebooks, mesh[4], cb.rotation)
    K2.launches = 0
    _, cand, _, _ = sharded_hybrid_search(
        ivf_idx.docs, no_pid, no_w, qrot, zero, None, ivf_idx.pq_codebooks,
        ivf_idx.ivf_centroids, ivf_idx.ivf_doc_ids, mesh=mesh[4], k=kk, c=kk,
        n_docs=ivf_idx.n_docs, ivf_probes=512, ivf_cell_size=ivf.cell_size)
    torch.cuda.synchronize()
    out["counts"]["ivf S=4"] = K2.launches
    check(K2.launches == 4, f"IVF S=4: K2 launched {K2.launches}x")
    out["ivf_cells_local"] = ivf_idx.ivf_centroids.shape[0] // 4
    recall = {}
    for name, ids in (("flat S=4", flat[4][1]), ("ivf512 S=4", cand)):
        _, top, _, _ = exact_rescore(qs, ids.cpu().numpy(), docs, k=k)
        recall[name] = float(np.mean([
            len(set(row.tolist()) & want) / k for row, want in zip(top, gold)
        ]))
    check(recall["flat S=4"] >= RECOVERY_FLOOR["flat"], f"{recall}")
    check(recall["ivf512 S=4"] >= RECOVERY_FLOOR["ivf512"], f"{recall}")
    out["recall"] = recall
    out["ms"]["pq flat S=4"] = time_ms(lambda: sharded_hybrid_search(
        pq_idx[4].docs, no_pid, no_w, qrot, zero, None, pq_idx[4].pq_codebooks,
        mesh=mesh[4], k=kk, c=kk, n_docs=RECOVERY_N), iters=5, warmup=1)
    out["ms"]["pq flat S=1"] = time_ms(lambda: sharded_hybrid_search(
        pq_idx[1].docs, no_pid, no_w, qrot, zero, None, pq_idx[1].pq_codebooks,
        mesh=one, k=kk, c=kk, n_docs=RECOVERY_N), iters=5, warmup=1)
    del pq_idx, ivf_idx
    torch.cuda.empty_cache()

    # -- 14e. both MaxSim modes at S=2 over the slab's first docs
    nm = N_MV_SHARDED
    q_tok, q_mask, q_pool = engine._encode_query_tokens(
        list(PRIMARY) + [""] * (8 - len(PRIMARY)))
    mv = {}
    for s, m in ((1, one), (2, mesh[2])):
        sidx = ShardedIndex.from_embeddings(store.embeddings[:nm], m)
        midx = ShardedMultiVectorIndex.from_arrays(
            store.mv_tokens[:nm], store.mv_mask[:nm], m,
            n_pad=sidx.docs.shape[0])
        mv[s] = (sidx, midx,
                 midx.search(q_tok, q_mask, 10),
                 midx.rerank_search(sidx, q_pool, q_tok, q_mask, 10, c=20))
    out["swaps"]["maxsim S=2"] = same_topk(torch, *mv[2][2], *mv[1][2],
                                           MAXSIM_TOL * MV_TD, "maxsim S=2")
    # maxsim-rerank at S=2: exact MaxSim (float64) over the union of each
    # shard's own dense top-20
    sidx, midx, _, (rs, ri) = mv[2]
    slab = midx.doc_tokens.full()
    smask = midx.doc_mask.full()
    half = sidx.docs.shape[0] // 2
    pools = []
    for shard in range(2):
        _, cand = _local_dense_topc(
            q_pool, sidx.docs.local((shard,)), shard * half, nm, 20)
        pools.append(cand)
    pool = torch.cat(pools, dim=1)
    qt64 = q_tok.to(torch.bfloat16).double()
    for qi in range(len(PRIMARY)):
        ids = sorted({int(d) for d in pool[qi].tolist() if 0 <= d < nm})
        sims = torch.einsum("td,nsd->tns", qt64[qi], slab[ids].double())
        sims = sims.masked_fill(smask[ids][None] <= 0, -math.inf)
        best = sims.amax(dim=2).masked_fill(
            torch.from_numpy(q_mask[qi]).to(dev)[:, None] <= 0, 0.0)
        s64 = best.sum(dim=0)
        order = sorted(range(len(ids)), key=lambda j: (-float(s64[j]), ids[j]))
        want = [ids[j] for j in order[:10]]
        got = ri[qi].tolist()
        n_tok = int(q_mask[qi].sum())
        for rank, d in enumerate(got):
            check(d in ids, f"maxsim-rerank S=2: doc {d} outside the pool")
            check(abs(float(rs[qi, rank]) - float(s64[ids.index(d)]))
                  <= MAXSIM_TOL * n_tok, "maxsim-rerank S=2: score")
        check(set(got) == set(want) or all(
            abs(float(s64[ids.index(a)]) - float(s64[ids.index(b)]))
            <= MAXSIM_TOL * n_tok for a, b in zip(got, want)),
            f"maxsim-rerank S=2 query {qi}: {got} vs {want}")
    del mv, slab
    torch.cuda.empty_cache()

    # -- 14f. three fine-tune steps at S=2 against three at S=1
    texts = [store.chunks[i]["text"] for i in range(4096)]
    losses = {}
    # one step first: the first backward's set-up is no step's time
    finetune_encoder(engine.encoder, texts, None, steps=1,
                     batch_size=FT_BATCH)
    for s, m in ((1, None), (2, mesh[2])):
        torch.cuda.synchronize()
        t0 = time.time()
        _, losses[s] = finetune_encoder(engine.encoder, texts, m,
                                        steps=FT_STEPS, batch_size=FT_BATCH)
        torch.cuda.synchronize()
        out["ms"][f"finetune S={s}"] = (time.time() - t0) / FT_STEPS * 1e3
    rel = float(np.max(np.abs(np.array(losses[2]) - losses[1])
                       / np.abs(losses[1])))
    check(rel <= FT_RTOL, f"fine-tune S=2 vs S=1: {losses[2]} vs {losses[1]}")
    out["losses"], out["loss_rel"] = losses, rel

    # -- 14g. K2 at seg_rows 3 and 12 against its plain version, and
    # pq_topk's top-20 there against float64 ADC
    codes_d = torch.from_numpy(codes[:N_PQ]).to(dev)
    cbs = torch.from_numpy(cb.codebooks).to(dev)
    out["seg_odd"] = {}
    for sr in SEG_ODD:
        for qp in (8, 64):
            q = qrot[:qp].contiguous()
            lut = pq_lut(q, cbs).to(torch.bfloat16).contiguous()
            got = pq_segmax(lut, codes_d, sr)
            ref = pq_segmax_reference(lut, codes_d, sr)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (qp, -(-N_PQ // sr)),
                  f"K2 seg_rows {sr} shape")
            err = float((got - ref).abs().max())
            check(err <= PQ_TOL, f"K2 seg_rows {sr} Q={qp}: error {err}")
            k2 = lambda: pq_segmax(lut, codes_d, sr)
            plain = lambda: pq_segmax_reference(lut, codes_d, sr)
            p1, ka, kb, p2 = (time_ms(f, iters=10, warmup=2)
                              for f in (plain, k2, k2, plain))
            K2.launches = 0
            s, i = pq_topk(q, codes_d, cbs, 20, seg_rows=sr)
            torch.cuda.synchronize()
            launches = K2.launches
            check(launches == 1, f"pq_topk(seg_rows={sr}) launched K2 "
                  f"{launches}x")
            lut64 = torch.einsum("qmd,mcd->qmc",
                                 q.double().reshape(qp, 2 * PQ_M, -1),
                                 cbs.double())
            assert_topk_equiv_scores(
                torch, adc_scores64(torch, lut64, codes_d), 20, s, i)
            out["seg_odd"][(sr, qp)] = {
                "k2_ms": (ka + kb) / 2, "plain_ms": (p1 + p2) / 2,
                "err": err, "launches": launches,
                "bound": bound(N_PQ * PQ_M + qp * 2 * PQ_M * 16 * 2
                               + qp * -(-N_PQ // sr) * 4,
                               qp * N_PQ * 2 * PQ_M, "fp32")}
    out["wall_s"] = time.time() - t_phase
    return out


def phase_headline(store_dir: str, device: str = "cuda") -> dict:
    """The port's headline bench over ``store_dir`` on ``device``: its
    record printed by ``bench.run``, its ids held against the exact
    golden, the CPU baseline and the captured graph under the tie rule,
    and every number finite and positive."""
    import numpy as np
    import torch

    from legal_rag_tpu_torch import bench

    t0 = time.time()
    metrics, arrays = bench.run(
        device=device, store_dir=store_dir,
        log=lambda line: print(f"phase 15: {line}", flush=True))
    out = {"metrics": metrics, "wall_s": time.time() - t0}
    check(metrics["timing"] == ("eager" if device == "cpu" else
                                "cuda_graph"), f"timing {metrics['timing']}")
    for key in ("dev_qps", "cpu_qps", "batch_device_ms", "single_device_ms",
                "sync_ms", "pipelined_ms", "single_p50_ms", "single_p90_ms",
                "dispatch_floor_ms", "encode_texts_per_s",
                "encode_texts_per_s_device"):
        check(math.isfinite(metrics[key]) and metrics[key] > 0,
              f"bench {key} {metrics[key]}")
    dev_f, dev_i = (torch.from_numpy(np.asarray(x)) for x in arrays["device"])
    check(dev_f.shape == dev_i.shape == (bench.Q_BATCH, bench.K),
          f"bench output shape {tuple(dev_f.shape)}")
    out["swaps"] = {}
    for name in ("golden", "cpu", "graph"):
        f, i = (torch.from_numpy(np.asarray(x)) for x in arrays[name])
        out["swaps"][name] = same_topk(torch, dev_f, dev_i, f, i, TOPK_TOL,
                                       f"bench vs {name}")
    # the verbatim recall counts a doc traded with a tied one as a miss
    check(metrics["recall_at_k"] == 1.0 or out["swaps"]["golden"] > 0,
          f"bench recall@{bench.K} {metrics['recall_at_k']}")
    if device != "cpu":
        # what the device does in one search of 64, eager and captured
        from legal_rag_tpu_torch.index.store import VectorStore

        store = VectorStore.load(store_dir)
        inputs = bench.bench_inputs(store, bench.sample_queries(
            store, bench.Q_BATCH))[:4]
        dev = torch.device(device)
        _, (search, _) = bench.searchers(store, *inputs, dev)
        replay, _ = bench.capture(search, dev)
        out["profile"] = {"eager": device_breakdown(torch, search, top=5),
                          "graph": device_breakdown(torch, replay, top=5)}
    return out


def print_headline(hd: dict) -> None:
    m = hd["metrics"]
    print(f"phase 15 ok: the headline bench over {m['source']} on "
          f"{m['device']} in {hd['wall_s']:.1f} s: batch of 64 "
          f"{m['batch_device_ms']:.4f} ms ({m['timing']} slope) = "
          f"{m['dev_qps']:.1f} qps, {m['dev_qps'] / m['cpu_qps']:.2f}x the "
          f"CPU baseline's {m['cpu_qps']:.1f} (numpy {m['blas']}, threads "
          f"{m['blas_threads']}, {m['cpu_count']} cores); single query "
          f"{m['single_device_ms']:.4f} ms ({m['timing']} slope), eager p50 "
          f"{m['single_p50_ms']:.4f} / p90 {m['single_p90_ms']:.4f} ms; eager"
          f" batch sync {m['sync_ms']:.4f}, pipelined {m['pipelined_ms']:.4f}"
          f" ms; dispatch floor {m['dispatch_floor_ms']:.4f} ms; recall@5 "
          f"{m['recall_at_k']} against the exact golden; ids == golden, "
          f"cpu_baseline and the graph's under the tie rule (ranks traded: "
          + ", ".join(f"{k} {v}" for k, v in hd["swaps"].items())
          + f"); encode {m['encode_texts_per_s']:.1f} texts/s wall, "
          f"{m['encode_texts_per_s_device']:.1f} device (slope, batch "
          f"{m['encode_batch_shape']})", flush=True)
    for mode, (wall, busy, top, launches) in hd.get("profile", {}).items():
        print(f"phase 15 ok: one {mode} search of 64 under torch.profiler: "
              f"wall {wall:.4f} ms, {launches} kernels, " + (
                  "no device time recorded" if busy is None else
                  f"device busy {busy:.4f} ms ({busy / wall:.1%}); largest "
                  + "; ".join(f"{name} {ms:.4f} ms" for name, ms in top)),
              flush=True)


def print_shards(sh: dict) -> None:
    ms, g = sh["ms"], sh["gather_ms"]
    print(f"phase 14 ok: S=2 on one card over the fp32 store ({sh['n_local']}"
          f" rows a shard, uploaded in {sh['upload_s']:.1f} s), "
          f"{SHARD_Q} queries: RRF and weighted ids == S=1 under the tie "
          f"rule ({sh['swaps']['S=2 rrf']} and {sh['swaps']['S=2 weighted']} "
          f"tied ranks trade places) and every returned doc placed as its "
          f"float64 channels allow; K1 launched "
          f"{sh['counts']['S=2 rrf']['K1']}x a search (once a shard); "
          f"search ms S=1 / S=2: rrf {ms[('rrf', 1)]:.3f} / "
          f"{ms[('rrf', 2)]:.3f}, weighted {ms[('weighted', 1)]:.3f} / "
          f"{ms[('weighted', 2)]:.3f}; K1 at a shard (Q={SHARD_Q}) "
          f"{sh['k1_shard']['ms']:.4f} ms, plain "
          f"{sh['k1_shard']['plain_ms']:.4f} ms, bound "
          f"{sh['k1_shard']['bound'][0]:.4f} ms; the candidates' gather alone "
          f"(CUDA events): S=2 {g[2]:.4f} ms, S=4 {g[4]:.4f} ms; 2x2 (data, "
          f"shard) mesh == S=2 under the tie rule", flush=True)
    for (backend, pid), rep in sh["workers"].items():
        print(f"phase 14 ok: {backend} process {pid} of {rep['world']} on "
              f"cuda:0: ids == this process's S={rep['world']} (tie rule), K1 "
              f"once a search; CUDA tensors to dist.all_gather: "
              f"{rep['cuda_all_gather']}; upload {rep['upload_s']:.1f} s, "
              f"search {rep['search_ms']:.3f} ms, candidates' gather "
              f"{rep['gather_ms']:.4f} ms", flush=True)
    print(f"phase 14 ok: PQ over the recovery workload ({RECOVERY_N} codes, "
          f"{RECOVERY_Q} queries): flat S=4 == S=1 under the tie rule, K2 "
          f"{sh['counts']['pq S=4']}x a search at S=4 ({ms['pq flat S=4']:.3f}"
          f" ms, S=1 {ms['pq flat S=1']:.3f} ms; K2 at a shard's "
          f"{sh['k2_shard']['rows']} codes {sh['k2_shard']['ms']:.4f} ms, "
          f"plain {sh['k2_shard']['plain_ms']:.4f} ms, bound "
          f"{sh['k2_shard']['bound'][0]:.4f} ms); IVF at 512 probes a shard "
          f"({sh['ivf_cells_local']} cells a shard) K2 "
          f"{sh['counts']['ivf S=4']}x; post-rescore recall@10 " + ", ".join(
              f"{n} {v}" for n, v in sh["recall"].items())
          + f" (floors {RECOVERY_FLOOR['flat']}, {RECOVERY_FLOOR['ivf512']})",
          flush=True)
    print(f"phase 14 ok: maxsim S=2 == S=1 over {N_MV_SHARDED} docs of the "
          f"slab; maxsim-rerank S=2 == exact float64 MaxSim over each "
          f"shard's own dense top-20; fine-tune {FT_STEPS} steps S=2 vs S=1 "
          f"losses {sh['losses'][2]} vs {sh['losses'][1]} (max rel "
          f"{sh['loss_rel']:.2e} <= {FT_RTOL}), {ms['finetune S=2']:.0f} vs "
          f"{ms['finetune S=1']:.0f} ms a step", flush=True)
    print("phase 14 ok: K2 at seg_rows " + "; ".join(
        f"{sr} Q={qp}: {t['k2_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), max abs err "
        f"{t['err']:.3g}" for (sr, qp), t in sh["seg_odd"].items())
        + f" on {N_PQ} codes (m={PQ_M}); pq_topk(seg_rows) top-20 == float64 "
        f"ADC under the tie rule, K2 once each; phase wall "
        f"{sh['wall_s']:.1f} s", flush=True)



GRAPH_N_REAL = (1, 5, 8, 64)   # real queries: buckets 8 (three fills) and 64
# the PRIMARY queries' words without the corpus's head words (whose
# postings run to ~10^6 at 1M docs): the 40 bit-for-bit cases a store
# then take seconds of host gather, not minutes
GRAPH_LIGHT = ("punishment robbery", "procedure file fir",
               "robbed gunpoint procedure rights victim")
# batches timed eager against graph with the PRIMARY queries, and the
# timed search_batch calls a turn, a store (the 1M store's victim
# queries gather 0.2 s of postings each on the host)
GRAPH_TIMED = {1_000_000: ((1, 8), 5), 2620: ((1, 8, 64), 10)}
# the in-process HTTP load: (clients, requests a client)
GRAPH_LOAD = ((1, 16), (16, 4))


def graph_queries(n: int, texts=PRIMARY):
    return [f"{texts[i % len(texts)]} (graph {i})" for i in range(n)]


def graph_rows(engine, queries, mode: str, use_graphs: bool):
    """search_batch's rows as (doc_id, score, semantic, keyword), through
    the engine's graphs or op by op."""
    engine.graphs.enabled = use_graphs
    try:
        return [[(r.doc_id, r.score, r.semantic, r.keyword) for r in row]
                for row in engine.search_batch(queries, k=10, mode=mode)]
    finally:
        engine.graphs.enabled = True


def fresh_graphs(engine):
    """A new graph set for ``engine`` and its encoder, whose every capture
    warms up under set_sync_debug_mode("error")."""
    from legal_rag_tpu_torch.utils.graphs import GraphSet

    graphs = GraphSet(engine.device, check_syncs=True)
    engine.graphs = engine.encoder.graphs = graphs
    return graphs


def stage_turns(engine, n: int, reps: int) -> list:
    """search_batch of ``n`` PRIMARY queries in turns eager, graph,
    graph, eager (``reps`` calls each after one untimed): the
    StageTimer's mean ms a stage and the wall p50 a call, per turn."""
    import statistics

    from legal_rag_tpu_torch.utils.timing import StageTimer

    queries, out = graph_queries(n), []
    for use in (False, True, True, False):
        graph_rows(engine, queries, "rrf", use)
        engine.timer, walls = StageTimer(), []
        engine.graphs.enabled = use
        try:
            for _ in range(reps):
                t0 = time.perf_counter()
                engine.search_batch(queries, k=10, mode="rrf")
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            engine.graphs.enabled = True
        snap = engine.timer.snapshot()
        out.append(("graph" if use else "eager", {
            "wall_p50_ms": statistics.median(walls),
            **{f"{k}_ms": v["mean_ms"] for k, v in snap.items()}}))
    return out


def phase_graphs(stores: dict) -> dict:
    """Phase 16: each store's tiers served through their CUDA graphs.
    ``stores``: {label: {tier: RetrievalEngine}}. Every tier, both modes
    and each of GRAPH_N_REAL real queries: the replay's rows equal the
    eager run's of the same engine bit for bit, each capture's warm-up
    under set_sync_debug_mode("error"); the launches inside replays; the
    fp32 engine's stages eager against graph."""
    import torch

    out = {}
    for label, engines in stores.items():
        t0 = time.time()
        reset_counts()
        sets, cases = {}, 0
        for tier, engine in engines.items():
            sets[tier] = fresh_graphs(engine)
            for mode in ("weighted", "rrf"):
                for n in GRAPH_N_REAL:
                    queries = graph_queries(n, GRAPH_LIGHT)
                    graph = graph_rows(engine, queries, mode, True)
                    eager = graph_rows(engine, queries, mode, False)
                    check(len(graph) == n and all(graph),
                          f"{label} {tier} {mode} n={n}: empty rows")
                    check(graph == eager, f"{label} {tier} {mode} n={n}: "
                          "the graph's rows differ from the eager run's")
                    cases += 1
        torch.cuda.synchronize()
        counts = read_counts()
        stats = {tier: g.stats() for tier, g in sets.items()}
        fp32 = engines["float32"]
        timed, reps = GRAPH_TIMED.get(fp32.store.n_docs, ((1, 8), 5))
        turns = {n: stage_turns(fp32, n, reps) for n in timed}
        out[label] = {"cases": cases, "counts": counts, "stats": stats,
                      "turns": turns, "reps": reps,
                      "wall_s": time.time() - t0,
                      "n_docs": fp32.store.n_docs}
    return out


def phase_graph_http(store_dir: str, seed: int) -> dict:
    """Phase 16b: the serving path over phase 9's store, the query
    encoder and the CE (a seeded head on the encoder's trunk where the
    build's gate persisted none) through one engine's graphs: the
    server's warm-up queries, then bench_http's clients against an
    in-process server in turns eager, graph, graph, eager; the encoder's
    and the CE's replays equal to their eager runs bit for bit; the
    graphs and pool bytes after the warm-up and after the load."""
    import numpy as np

    from legal_rag_tpu_torch.cli import WARMUP_QUERIES, BackgroundServer
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine
    from legal_rag_tpu_torch.scripts import bench_http

    store = VectorStore.load(store_dir)
    if store.ce_params is None:
        rng = np.random.default_rng(seed)
        store.ce_params = {"trunk": store.encoder_params, "head": {
            "w": (0.02 * rng.standard_normal(store.dim)).astype(np.float32),
            "b": np.zeros((), np.float32)}}
    legal = LegalEngine(store=store, use_llm=False, device="cuda")
    engine, ce = legal.engine, legal.orchestrator.reranker
    check(ce is not None and ce.graphs is engine.graphs is
          engine.encoder.graphs, "the CE does not share the engine's graphs")
    graphs = engine.graphs
    graphs.check_syncs = True
    t0 = time.time()
    for q in WARMUP_QUERIES:
        legal.query(q)
    out = {"warmup_s": time.time() - t0, "after_warmup": graphs.stats()}
    texts = list(bench_http.QUERIES)
    docs = [c["text"] for c in store.chunks[:len(texts)]]
    got = (engine.encoder.encode(texts), ce.score_pairs(texts, docs))
    graphs.enabled = False
    try:
        want = (engine.encoder.encode(texts), ce.score_pairs(texts, docs))
    finally:
        graphs.enabled = True
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "the encoder's or the CE's replay differs from its eager run")
    kinds = {key[0] for key in graphs.programs}
    check({"search", "encode", "cross_encode"} <= kinds,
          f"programs captured: {sorted(kinds)}")
    graphs.check_syncs = False     # process-wide: not under server threads
    engine.enable_request_coalescing()
    server = BackgroundServer(legal)
    rows = []
    try:
        for use in (False, True, True, False):
            graphs.enabled = use
            bench_http.run_level(server.port, 1, len(bench_http.QUERIES))
            for clients, n in GRAPH_LOAD:
                row = bench_http.run_level(server.port, clients, n)
                check(row["n_errors"] == 0, f"bench_http errors: {row}")
                rows.append(("graph" if use else "eager", row))
    finally:
        graphs.enabled = True
        server.stop()
    out.update(rows=rows, after_load=graphs.stats(),
               wall_s=time.time() - t0)
    return out


def print_graphs(gr: dict, http: dict) -> None:
    for label, g in gr.items():
        st = g["stats"]
        print(f"phase 16 ok: {label} ({g['n_docs']} docs): {g['cases']} "
              f"cases (tiers {', '.join(st)}; weighted and rrf; "
              f"{', '.join(map(str, GRAPH_N_REAL))} real queries) replayed "
              f"== eager bit for bit, every warm-up under "
              f"set_sync_debug_mode('error'); launches in replays: "
              + ", ".join(f"{k} {g['counts'][k + ' in replays']}"
                          for k in ("K1", "K1-int8", "K2"))
              + " (direct: " + ", ".join(
                  f"{k} {g['counts'][k] - g['counts'][k + ' in replays']}"
                  for k in ("K1", "K1-int8", "K2"))
              + "); graphs a tier, capture s (mean, max), pool MB, static "
              "inputs MB: " + "; ".join(
                  f"{tier} {s['graphs']}, {sum(s['capture_s']) / len(s['capture_s']):.4f} / "
                  f"{max(s['capture_s']):.4f}, {s['pool_bytes'] / 2**20:.1f}, "
                  f"{s['input_bytes'] / 2**20:.1f}" for tier, s in st.items())
              + f"; {g['wall_s']:.1f} s", flush=True)
        print(f"phase 16 ok: {label} fp32 rrf, PRIMARY queries, eager "
              f"against graph, mean stage ms and wall p50 ms over "
              f"{g['reps']} calls a turn: "
              + "; ".join(f"n={n}: " + " | ".join(
                  f"{turn} " + ", ".join(f"{k[:-3]} {v:.4f}"
                                         for k, v in t.items())
                  for turn, t in turns)
                  for n, turns in g["turns"].items()), flush=True)
    a, b = http["after_warmup"], http["after_load"]
    print(f"phase 16b ok: the served path over phase 9's store through one "
          f"graph set (search, encoder, CE); encoder and CE replays == eager "
          f"bit for bit; warm-up {http['warmup_s']:.2f} s captured "
          f"{a['graphs']} graphs (capture s {sum(a['capture_s']):.3f}, pool "
          f"{a['pool_bytes'] / 2**20:.1f} MB); after the load "
          f"{b['graphs']} graphs ({b['replays']} replays, pool "
          f"{b['pool_bytes'] / 2**20:.1f} MB, static inputs "
          f"{b['input_bytes'] / 2**20:.1f} MB); bench_http clients in "
          f"process, turns eager/graph/graph/eager: " + "; ".join(
              f"{turn} c={r['concurrency']} p50 {r['p50_ms']} ms p99 "
              f"{r['p99_ms']} ms qps {r['qps']}" for turn, r in http["rows"])
          + f"; {http['wall_s']:.1f} s", flush=True)


class Laps:
    """Seconds of each phase: ``mark(label)`` ends the running phase and
    starts ``label`` (None: the last one ends)."""

    def __init__(self, first: str) -> None:
        self.done, self._name, self._t0 = [], first, time.time()

    def mark(self, name) -> None:
        now = time.time()
        self.done.append((self._name, now - self._t0))
        self._name, self._t0 = name, now


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
    laps = Laps("1")
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

    laps.mark("2")
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

    laps.mark("2b")
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

    laps.mark("2c/2d")
    # -- 2c/2d. K2 against its plain version, and the recovery workload
    (err_pq, times_pq, recall, (t_data, t_train), times_w, times_sr,
     recovery) = phase_pq(torch, args.seed)
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
    print(f"phase 2c ok: K2 == plain within {PQ_TOL} at seg_rows "
          f"{', '.join(map(str, PQ_SEG_ROWS))} on the {N_PQ} codes (m={PQ_M})"
          f" at Q {' and '.join(map(str, PQ_SEG_QS))}; pq_topk(seg_rows=16) "
          f"top-10 == float64 ADC under the tie rule; seg_rows 16: " + "; ".join(
              f"Q={qp}: K2 {t['k2_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"pq_topk top-10 {t['pq_topk_ms']:.4f} ms"
              for qp, t in times_sr.items()), flush=True)
    print(f"phase 2d ok: recovery workload ({RECOVERY_N} clustered docs, "
          f"{RECOVERY_Q} queries, corpus {t_data:.1f} s, PQ + OPQ + IVF "
          f"trained and coded on the card in {t_train:.1f} s): post-rescore "
          f"recall@10 at oversample {RECOVERY_OVERSAMPLE}: " + ", ".join(
              f"{name} {recall[name]} (floor {RECOVERY_FLOOR[name]}, "
              f"EVAL_IVF_RECOVERY.json {RECOVERY_REPO[name]})"
              for name in recall), flush=True)

    laps.mark("2e/2f/2g")
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

    laps.mark("2h")
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

    laps.mark("2i")
    # -- 2i. the kernel scripts of the evaluation slice at reduced size
    ks = phase_kernel_scripts(torch)
    torch.cuda.empty_cache()
    print_kernel_scripts(ks)

    laps.mark("3")
    # -- 3. synthetic store at serving scale, with PQ and IVF artifacts
    store, expansions = phase_store(args.docs, args.seed, "cuda")
    check(store.pq_codes is not None and store.ivf_centroids is not None,
          "store lacks its PQ/IVF artifacts")

    laps.mark("4")
    # -- 4. the port's main path: HTTP server over the engine on the card
    legal, counts, served = phase_serve(store, args.docs, "cuda")
    engine = legal.engine

    laps.mark("5")
    # -- 5. the same searches through a second engine on the CPU
    phase_compare(store, engine, expansions, served)

    laps.mark("6")
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

    laps.mark("7")
    # -- 7. each quantized tier on the card against the CPU
    phase_compare_tiers(store, tier_engines, ivf_engine, engine, expansions)

    laps.mark("8")
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
    wall, busy, top, _ = mx["profile"]
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

    laps.mark("9")
    # -- 9. the build path: ingest, build (fine-tune, PQ + IVF, token
    # slab, CE and its gate), serve, the card against the CPU
    b = phase_build(args.seed)
    torch.cuda.empty_cache()
    print_build(b)

    laps.mark("10")
    # -- 10. the evaluation path over phase 9's store: the eval commands
    # on the card and the CPU, K2 on the pq mode, the eval scripts
    ev = phase_eval(b["store_dir"])
    torch.cuda.empty_cache()
    print_eval(ev)

    laps.mark("11")
    # -- 11. the native tokenizer on the card's host, over phase 9's store
    nat = phase_native(b)
    print_native(nat, b)

    laps.mark("12")
    # -- 12. the benches: bench_hybrid_scale at 1M docs (K1), bench_http
    bn = phase_benches(b)
    torch.cuda.empty_cache()
    print_benches(bn)

    laps.mark("13")
    # -- 13. the deployment entry points over phase 9's store
    print_entry_points(phase_entry_points(b))

    laps.mark("14")
    # -- 14. multi-GPU sharding on the one card: S=2 and a 2x2 mesh over
    # the fp32 store, the gloo and NCCL process groups, PQ and IVF at S=4,
    # both MaxSim modes and the fine-tune at S=2, K2 at odd seg_rows
    sh = phase_shards(store, engine, recovery, args.seed)
    del recovery
    torch.cuda.empty_cache()
    print_shards(sh)

    laps.mark("15")
    # -- 15. the headline bench over phase 9's store
    print_headline(phase_headline(b["store_dir"]))
    torch.cuda.empty_cache()

    laps.mark("16")
    # -- 16. the served programs as CUDA graphs, every tier over phase 3's
    # store and phase 9's, eager against graph; then the serving path
    # over phase 9's store (encoder and CE too) under bench_http's clients
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    small = VectorStore.load(b["store_dir"])
    gr = phase_graphs({
        "phase 3's store": {
            "float32": engine,
            "bfloat16": RetrievalEngine(store, config=tier_config("bfloat16")),
            "int8": tier_engines["int8"], "pq": tier_engines["pq"],
            "pq + IVF": ivf_engine},
        "phase 9's store": {
            tier: RetrievalEngine(small, config=cfg) for tier, cfg in (
                ("float32", tier_config("float32")),
                ("bfloat16", tier_config("bfloat16")),
                ("int8", tier_config("int8")),
                ("pq", tier_config("pq", use_ivf=False, pq_oversample=64)),
                ("pq + IVF", pq_ivf_config()))},
    })
    gr_http = phase_graph_http(b["store_dir"], args.seed)
    print_graphs(gr, gr_http)
    torch.cuda.empty_cache()
    laps.mark(None)
    print("phase seconds: " + ", ".join(f"{name} {secs:.1f}"
                                        for name, secs in laps.done),
          flush=True)

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
    k1_bound = bound(N_ROWS * DIM * 4 + 8 * DIM * 4 + 8 * N_ROWS // 8 * 4,
                     2 * 8 * N_ROWS * DIM, "fp32")
    i8_bound = bound(N_ROWS * DIM + 8 * DIM + 8 * N_ROWS // 8 * 4,
                     2 * 8 * N_ROWS * DIM, "int8")
    k2_bound = bound(N_PQ * PQ_M + 8 * 2 * PQ_M * 16 * 2 + 8 * N_PQ // 8 * 4,
                     8 * N_PQ * 2 * PQ_M, "fp32")
    rows = [
        ("segmax_rm (K1)", "segmax_rm.cu", "legal_rag_tpu/ops/dense.py:495",
         counts["K1"], max_err, k1_t["k1_ms"], k1_t["plain_ms"], k1_bound,
         None),
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
        # bench_hybrid_scale's dense stage: bf16 docs, 64 queries
        ("segmax_rm tensor cores (K1, bench_hybrid_scale bf16 Q=64)",
         "segmax_rm.cu", "legal_rag_tpu/ops/dense.py:495",
         bn["counts"]["K1"], max_err, times[("bf16", 64)]["k1_ms"],
         times[("bf16", 64)]["plain_ms"],
         bound(N_ROWS * DIM * 2 + 64 * DIM * 2 + 64 * N_ROWS // 8 * 4,
               2 * 64 * N_ROWS * DIM, "bf16"), None),
        ("segmax_rm int8 (K1-int8)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:515", tier_counts["int8"]["K1-int8"],
         err_i8, k1_i8_t["k1_ms"], k1_i8_t["plain_ms"], i8_bound, None),
        ("pq_segmax (K2)", "pq_segmax.cu", "legal_rag_tpu/ops/pq.py:257",
         ivf_counts["K2"] + tier_counts["pq"]["K2"], err_pq, k2_t["k2_ms"],
         k2_t["plain_ms"], k2_bound, None),
        # bench_pq's seg_rows-16 rows (phase 2i), timed at Q=64 over the
        # 1M codes of phase 2c
        ("pq_segmax (K2, seg_rows 16)", "pq_segmax.cu",
         "legal_rag_tpu/ops/pq.py:257", sum(
             r.get("k2_launches", 0) for r in ks["rows"]["bench_pq"]
             if "sr=16" in r["name"]), err_pq, times_sr[64]["k2_ms"],
         times_sr[64]["plain_ms"],
         bound(N_PQ * PQ_M + 64 * 2 * PQ_M * 16 * 2 + 64 * N_PQ // 16 * 4,
               64 * N_PQ * 2 * PQ_M, "fp32"), None),
        # the evaluation path: eval-retrieval's pq mode over the IVF cells
        ("pq_segmax (K2, eval pq mode)", "pq_segmax.cu",
         "legal_rag_tpu/ops/pq.py:257", ev["counts"]["K2"], ev["k2_err"],
         ev["k2"]["ms"], ev["k2"]["plain_ms"], ev["k2"]["bound"], None),
        # phase 14: the sharded search at S=2 (fp32, Q=64, once a shard)
        # at one shard's rows, the time and bound of one launch
        ("segmax_rm tensor cores (K1, sharded S=2 Q=64)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:495",
         sh["counts"]["S=2 rrf"]["K1"] + sh["counts"]["S=2 weighted"]["K1"],
         sh["k1_shard"]["err"], sh["k1_shard"]["ms"],
         sh["k1_shard"]["plain_ms"], sh["k1_shard"]["bound"], None),
        # PQ flat and IVF at S=4 over the recovery codes (Q=64, once a
        # shard): one launch over one shard's codes
        ("pq_segmax (K2, sharded S=4 Q=64)", "pq_segmax.cu",
         "legal_rag_tpu/ops/pq.py:257",
         sh["counts"]["pq S=4"] + sh["counts"]["ivf S=4"],
         sh["k2_shard"]["err"], sh["k2_shard"]["ms"],
         sh["k2_shard"]["plain_ms"], sh["k2_shard"]["bound"], None),
        *[(f"pq_segmax (K2, seg_rows {sr}, Q=64)", "pq_segmax.cu",
           "legal_rag_tpu/ops/pq.py:257", t["launches"], t["err"],
           t["k2_ms"], t["plain_ms"], t["bound"], None)
          for (sr, qp), t in sh["seg_odd"].items() if qp == 64],
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
    # phase 16: the kernels inside the served graphs' replays over phase
    # 3's store (fp32 and bf16 tiers: K1; int8: K1-int8; pq, IVF: K2)
    big = gr["phase 3's store"]["counts"]
    rows += [
        ("segmax_rm (K1, graph replays)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:495", big["K1"], max_err,
         k1_t["k1_ms"], k1_t["plain_ms"], k1_bound, None),
        ("segmax_rm int8 (K1-int8, graph replays)", "segmax_rm.cu",
         "legal_rag_tpu/ops/dense.py:515", big["K1-int8"], err_i8,
         k1_i8_t["k1_ms"], k1_i8_t["plain_ms"], i8_bound, None),
        ("pq_segmax (K2, graph replays)", "pq_segmax.cu",
         "legal_rag_tpu/ops/pq.py:257", big["K2"], err_pq, k2_t["k2_ms"],
         k2_t["plain_ms"], k2_bound, None),
    ]
    # of each row's launches, those made inside CUDA-graph replays
    replayed = {
        "segmax_rm (K1)": counts["K1 in replays"],
        "segmax_rm tensor cores (K1, Q=64)":
            served[64][1]["K1 tensor cores in replays"],
        "segmax_rm tensor cores (K1, Q=128)":
            served[68][1]["K1 tensor cores in replays"],
        "segmax_rm int8 (K1-int8)": tier_counts["int8"]["K1-int8 in replays"],
        "pq_segmax (K2)": (ivf_counts["K2 in replays"]
                           + tier_counts["pq"]["K2 in replays"]),
        "pq_segmax (K2, eval pq mode)": ev["counts"]["K2 in replays"],
        "segmax_rm (K1, graph replays)": big["K1 in replays"],
        "segmax_rm int8 (K1-int8, graph replays)": big["K1-int8 in replays"],
        "pq_segmax (K2, graph replays)": big["K2 in replays"],
    }
    for name, _, _, launches, *_ in rows:
        check(launches > 0, f"{name} was not launched on its path")
    for name in ("segmax_rm (K1, graph replays)",
                 "segmax_rm int8 (K1-int8, graph replays)",
                 "pq_segmax (K2, graph replays)"):
        check(replayed[name] > 0, f"{name}: no launch inside a replay")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"legal_rag_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches, "launches_in_replays": replayed.get(name, 0),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
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
