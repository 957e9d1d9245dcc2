"""The headline bench on one CUDA card: batched hybrid retrieval QPS of a
card against the CPU baseline, the counterpart of the JAX package's
``bench.py``.

Prints ONE JSON line to stdout, last:
    {"metric": "hybrid_search_qps_per_chip_batch64", "value": N,
     "unit": "qps", "vs_baseline": N}
Details go to stderr (``log``), ending in one JSON line of diagnostics.

Baseline: the reference stack is FAISS IndexFlatIP + rank_bm25 on the
CPU. ``cpu_baseline`` is the JAX bench's numpy copy of that math (BLAS
sgemm + argpartition top-k, ``np.add.at`` postings scatter, vectorized
fusion), run on this host; its BLAS and thread count are logged beside
``cpu_qps``, since ``vs_baseline`` depends on them.

Measured op: the hybrid search core for a batch of 64 queries
(``sharded_hybrid_search`` on a one-card mesh: dense top-2k, full-corpus
BM25, weighted fusion at 0.5, top-k), queries already embedded, postings
already gathered on both sides. The number of record is device time by
the SLOPE method: one search is captured as a CUDA graph over fixed
input tensors, replayed r times with one sync at the end, and
``(t(4096) - t(64)) / 4032`` (best of 3 each) is the time of a search;
the host's constant cost cancels. The same for the 8-wide single-query
bucket. Wall diagnostics, made eagerly: the dispatch floor (a trivial
op's sync time), sync and pipelined ms a batch over ``REPEATS``, and
the single-query p50/p90 over 50 calls. Then recall@K of the batch's ids
against the exact golden, and the encoder: wall texts/s of
``encoder.encode`` on the 64 queries, and device texts/s by the slope
over a captured MiniLM forward of 64 median-length chunks
(``BENCH_SKIP_ENCODE=1`` skips it). On the CPU (``device="cpu"``) the
slopes time eager calls and the record says ``"timing": "eager"``.

The store: ``--store DIR`` (a store of either package), else one built
by the port's ``build_index`` with ``RetrievalConfig()`` and cached
under ``.bench_cache/torch_store``, from ``--chunks FILE`` (the real
corpus's chunks json) or, without it, from a synthetic markdown corpus
in the five laws' shape (``ingest.synthetic.write_legal_corpus``, 2,620
chunks, seed 0) through the port's ingest.

Any failure raises: there is no fallback number.

Run on the card:  python -m legal_rag_tpu_torch.bench [--store DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache", "torch_store")
METRIC = "hybrid_search_qps_per_chip_batch64"

Q_BATCH = 64
K = 5
REPEATS = 30
SINGLE_Q = 8            # the serving path pads tiny batches to 8 rows
WEIGHT = 0.5
SLOPE_R = (64, 4096)    # searches a timed run, the JAX bench's
ENCODE_R = (4, 34)      # MiniLM forwards a timed run, the JAX bench's
SYNTH_CHUNKS, SYNTH_SEED = 2620, 0
# one H100 SXM from NVIDIA's data sheet: HBM rate, fp32 rate outside the
# tensor cores (the search's matmul runs in true fp32)
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12

Log = Callable[[str], None]


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def build_store(chunks: Optional[str] = None, device="cuda",
                log: Log = log):
    """The bench's store: built by ``build_index`` from ``chunks`` (a
    chunks json) or the synthetic corpus, and cached under ``CACHE``
    (``build_index`` returns the cached store when its corpus hash
    matches). Returns ``(store, source)``."""
    from legal_rag_tpu_torch.config import RetrievalConfig
    from legal_rag_tpu_torch.index.builder import build_index

    if chunks is not None:
        source, cache = chunks, os.path.join(CACHE, "chunks")
    else:
        from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

        source = os.path.join(CACHE, "synthetic_docs")
        write_legal_corpus(source, n_chunks=SYNTH_CHUNKS, seed=SYNTH_SEED)
        cache = os.path.join(CACHE, "synthetic")
    t0 = time.time()
    store = build_index(source, config=RetrievalConfig(), store_dir=cache,
                        device=device)
    log(f"index ready: n={store.n_docs} dim={store.dim} "
        f"({time.time() - t0:.1f}s)")
    return store, (chunks if chunks is not None else
                   f"synthetic ({SYNTH_CHUNKS} chunks, seed {SYNTH_SEED})")


def sample_queries(store, n, seed=0):
    """Realistic keyword-bearing queries drawn from corpus vocabulary."""
    rng = np.random.default_rng(seed)
    texts = [c["text"] for c in store.chunks]
    out = []
    for _ in range(n):
        t = texts[rng.integers(len(texts))]
        words = [w for w in t.split() if w.isalpha()]
        take = rng.integers(3, 9)
        if len(words) >= take:
            lo = rng.integers(0, len(words) - take + 1)
            out.append(" ".join(words[lo : lo + take]))
        else:
            out.append("punishment for robbery under section")
    return out


def cpu_baseline(store, q_emb, post_ids, post_w, weights, k):
    """FAISS-flat + rank_bm25-equivalent CPU hybrid search."""
    docs = store.embeddings
    n = store.n_docs
    c = 2 * k

    def run():
        dense = q_emb @ docs.T                                   # sgemm
        # partial-select then stable sort with ascending-id tie-break
        # (exact ties are common — duplicate chunk texts — and FAISS's
        # heap also resolves them to the lowest id)
        part = np.argpartition(-dense, c - 1, axis=1)[:, : 4 * c]
        part.sort(axis=1)  # ascending ids so the stable sort ties by id
        part_s = np.take_along_axis(dense, part, axis=1)
        order = np.argsort(-part_s, axis=1, kind="stable")[:, :c]
        cand = np.take_along_axis(part, order, axis=1)
        cand_s = np.take_along_axis(part_s, order, axis=1)

        bm = np.zeros((q_emb.shape[0], n), dtype=np.float32)
        for qi in range(q_emb.shape[0]):
            valid = post_ids[qi] < n
            np.add.at(bm[qi], post_ids[qi][valid], post_w[qi][valid])
        mx = bm.max(axis=1, keepdims=True)
        mx[mx <= 0] = 1.0
        bmn = bm / mx
        cand_bm = np.take_along_axis(bmn, cand, axis=1)
        fused = cand_s * (1 - weights[:, None]) + cand_bm * weights[:, None]
        forder = np.argsort(-fused, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(fused, forder, axis=1),
            np.take_along_axis(cand, forder, axis=1),
        )

    run()  # warmup
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        f, ids = run()
    dt = (time.perf_counter() - t0) / REPEATS
    return f, ids, dt


def bench_inputs(store, queries):
    """The JAX bench's search inputs, seed 1: perturbed corpus rows as
    query embeddings (unit vectors with a realistic similarity
    structure), the postings at a power-of-two budget of at least 64,
    and the fusion weights. Returns ``(q_emb, post_ids, post_w,
    weights, budget)``."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, store.n_docs, Q_BATCH)
    q_emb = store.embeddings[rows] + 0.05 * rng.standard_normal(
        (Q_BATCH, store.dim)
    ).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)

    budget = max(64, store.bm25.postings_budget(queries))
    budget = 1 << (budget - 1).bit_length()
    post_ids, post_w = store.bm25.gather_postings(queries, budget)
    weights = np.full(Q_BATCH, WEIGHT, dtype=np.float32)
    return q_emb, post_ids, post_w, weights, budget


def exact_golden(store, q_emb, post_ids, post_w):
    """The exact weighted hybrid top-K (full stable argsort, score desc
    / id asc: the math FAISS flat performs). Returns ``(fused [Q, K],
    ids [Q, K])``."""
    n_q = q_emb.shape[0]
    dense = q_emb @ store.embeddings.T
    cand = np.argsort(-dense, axis=1, kind="stable")[:, : 2 * K]
    bm = np.zeros((n_q, store.n_docs), dtype=np.float32)
    for qi in range(n_q):
        valid = post_ids[qi] < store.n_docs
        np.add.at(bm[qi], post_ids[qi][valid], post_w[qi][valid])
    mx = bm.max(axis=1, keepdims=True)
    mx[mx <= 0] = 1.0
    fused = (
        np.take_along_axis(dense, cand, axis=1) * 0.5
        + np.take_along_axis(bm / mx, cand, axis=1) * 0.5
    )
    order = np.argsort(-fused, axis=1, kind="stable")[:, :K]
    return (np.take_along_axis(fused, order, axis=1),
            np.take_along_axis(cand, order, axis=1))


def recall_at_k(dev_ids, gold_ids) -> float:
    """Mean overlap of each row's ids with the golden row's, over K."""
    return float(np.mean([
        len(set(dev_ids[i]) & set(gold_ids[i])) / K
        for i in range(len(gold_ids))
    ]))


def blas_info() -> Dict:
    """numpy's BLAS and its threads on this host: the thread count is
    asked of the OpenBLAS library this process has loaded (None where
    none is found, as off Linux)."""
    blas = getattr(np.__config__, "CONFIG", {}).get(
        "Build Dependencies", {}).get("blas", {})
    threads = None
    try:
        with open("/proc/self/maps") as f:
            libs = {ln.split()[-1] for ln in f if "openblas" in ln.lower()
                    and ".so" in ln}
    except OSError:
        libs = set()
    for path in sorted(libs):
        lib = ctypes.CDLL(path)
        for name in ("openblas_get_num_threads", "openblas_get_num_threads64_",
                     "scipy_openblas_get_num_threads",
                     "scipy_openblas_get_num_threads64_"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = ctypes.c_int
                threads = fn()
                break
    return {"blas": f"{blas.get('name')} {blas.get('version')}",
            "blas_threads": threads, "cpu_count": os.cpu_count()}


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    (``"cpu"`` off the card)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture(fn: Callable, device: torch.device):
    """``fn`` (fixed input tensors, no arguments) as a program to replay:
    on the card a CUDA graph in a private memory pool, captured after
    three warm-up calls on a side stream; on the CPU the eager call.
    Returns ``(replay, outputs)``: after a replay the outputs hold its
    results."""
    if device.type != "cuda":
        return fn, fn()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
        out = fn()
    return graph.replay, out


def measure_slope(replay: Callable, device: torch.device, r1: int, r2: int,
                  log: Log = log, tries: int = 3) -> float:
    """Seconds a call of ``replay`` by the slope: ``r`` calls back to
    back and one sync, best of ``tries`` at ``r1`` and ``r2``; raises
    when the difference is not positive."""
    def timed(r):
        best = float("inf")
        for _ in range(tries):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(r):
                replay()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        return best

    t_r1, t_r2 = timed(r1), timed(r2)
    dt = (t_r2 - t_r1) / (r2 - r1)
    log(f"slope: t({r1})={t_r1*1e3:.1f} ms t({r2})={t_r2*1e3:.1f} ms"
        f" -> {dt*1e6:.2f} us/iter")
    if not dt > 0:
        raise RuntimeError(f"non-positive slope: t({r1})={t_r1} s, "
                           f"t({r2})={t_r2} s")
    return dt


def dispatch_floor(device: torch.device) -> float:
    """Seconds a trivial op takes to run and sync (mean of 10)."""
    probe = torch.ones((8, 128), device=device)
    probe * 2 + 1
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(10):
        probe * 2 + 1
        _sync(device)
    return (time.perf_counter() - t0) / 10


def searchers(store, q_emb, post_ids, post_w, weights, device="cuda",
              rows=(Q_BATCH, SINGLE_Q)):
    """The device path: the store's embeddings on a one-device mesh and,
    for each batch of ``rows``, a search without arguments over the
    first rows of the inputs, fixed tensors on the device
    (``sharded_hybrid_search``, weighted, k=K, c=2K). Returns ``(mesh,
    [search, ...])``; a search returns ``(fused, ids, sem, keyword)``."""
    from legal_rag_tpu_torch.parallel.mesh import make_mesh
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    mesh = make_mesh(1, device=device)
    index = ShardedIndex.from_embeddings(store.embeddings, mesh)
    dev = index.docs.device

    def searcher(n: int):
        q, pids, pw, w = (torch.from_numpy(np.ascontiguousarray(x[:n]))
                          .to(dev) for x in (q_emb, post_ids, post_w,
                                             weights))

        def search():
            return sharded_hybrid_search(
                index.docs, pids, pw, q, w, mesh=mesh, k=K, c=2 * K,
                n_docs=store.n_docs, mode="weighted",
            )
        return search

    return mesh, [searcher(n) for n in rows]


def measure(store, device="cuda", source: str = "", log: Log = log,
            slope_r=SLOPE_R):
    """The module doc's measurements over ``store`` on ``device``.
    Returns ``(metrics, arrays)``: the numbers of the stderr record, and
    the ``(fused, ids)`` numpy pairs of the batch of 64 from the device
    (an eager call), the captured program, the CPU baseline and the
    exact golden."""
    device = torch.device(device)
    # fp32 products in true fp32: the golden is fp32 (the engine sets
    # this too, but the bench calls the search directly)
    torch.backends.cuda.matmul.allow_tf32 = False
    metrics: Dict = {"source": source, "device": card_label(device),
                     "timing": "cuda_graph" if device.type == "cuda"
                     else "eager"}

    queries = sample_queries(store, Q_BATCH)
    q_emb, post_ids, post_w, weights, budget = bench_inputs(store, queries)
    # the least time a card could take for a search of 64: its inputs
    # read once over the HBM rate, or its matmul over the fp32 rate
    n_bytes = (store.embeddings.nbytes + q_emb.nbytes + post_ids.nbytes
               + post_w.nbytes + weights.nbytes)
    n_ops = 2 * Q_BATCH * store.n_docs * store.dim
    metrics.update(postings_budget=budget, bound_ms=max(
        n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3)
    log(f"postings budget: {budget}; bound {metrics['bound_ms']*1e3:.2f} us "
        f"a batch ({n_bytes} bytes, {n_ops} fp32 operations)")

    # ---- CPU baseline
    cpu_f, cpu_ids, cpu_dt = cpu_baseline(store, q_emb, post_ids, post_w,
                                          weights, K)
    metrics["cpu_qps"] = Q_BATCH / cpu_dt
    metrics.update(blas_info())
    log(f"CPU baseline: {cpu_dt*1e3:.2f} ms/batch -> "
        f"{metrics['cpu_qps']:.0f} QPS (numpy BLAS {metrics['blas']}, "
        f"threads {metrics['blas_threads']}, {metrics['cpu_count']} cores)")

    # ---- device path
    mesh, (device_run, single) = searchers(
        store, q_emb, post_ids, post_w, weights, device)
    t0 = time.time()
    out = device_run()
    _sync(device)
    single()
    _sync(device)
    log(f"search programs warm ({time.time() - t0:.1f}s)")

    batch_replay, graph_out = capture(device_run, device)
    single_replay, _ = capture(single, device)
    slope_dt = measure_slope(batch_replay, device, *slope_r, log=log)
    metrics["dev_qps"] = Q_BATCH / slope_dt
    metrics["batch_device_ms"] = slope_dt * 1e3
    log(f"dev_qps={metrics['dev_qps']:.0f} ({metrics['timing']} slope, "
        f"{slope_dt*1e6:.1f} us/batch-{Q_BATCH})")
    sq_dt = measure_slope(single_replay, device, *slope_r, log=log)
    metrics["single_device_ms"] = sq_dt * 1e3
    log(f"single-query device time ({metrics['timing']} slope): "
        f"{sq_dt*1e6:.1f} us")

    # ---- wall diagnostics, eager
    floor = dispatch_floor(device)
    metrics["dispatch_floor_ms"] = floor * 1e3
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        device_run()
        _sync(device)
    metrics["sync_ms"] = (time.perf_counter() - t0) / REPEATS * 1e3
    pipe_n = REPEATS * 5
    t0 = time.perf_counter()
    outs = [device_run() for _ in range(pipe_n)]
    outs[-1][0].cpu()
    metrics["pipelined_ms"] = (time.perf_counter() - t0) / pipe_n * 1e3
    del outs
    log(f"dispatch floor {metrics['dispatch_floor_ms']:.4f} ms; eager: sync "
        f"{metrics['sync_ms']:.3f} ms/batch, pipelined "
        f"{metrics['pipelined_ms']:.3f} ms/batch (wall diagnostics)")
    for _ in range(10):
        single()
        _sync(device)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        single()
        _sync(device)
        lat.append(time.perf_counter() - t0)
    metrics["single_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    metrics["single_p90_ms"] = float(np.percentile(lat, 90)) * 1e3
    log(f"single-query p50: {metrics['single_p50_ms']:.3f} ms "
        f"(p90 {metrics['single_p90_ms']:.3f} ms)")

    # ---- correctness: recall@K against the exact golden
    gold_f, gold_ids = exact_golden(store, q_emb, post_ids, post_w)
    dev_f, dev_ids = out[0].cpu().numpy(), out[1].cpu().numpy()
    metrics["recall_at_k"] = recall_at_k(dev_ids, gold_ids)
    log(f"recall@{K} vs exact golden: {metrics['recall_at_k']:.4f}")
    arrays = {"device": (dev_f, dev_ids),
              "graph": (graph_out[0].cpu().numpy(),
                        graph_out[1].cpu().numpy()),
              "cpu": (cpu_f, cpu_ids), "golden": (gold_f, gold_ids)}

    if os.environ.get("BENCH_SKIP_ENCODE") != "1":
        metrics.update(measure_encoder(store, queries, mesh, device, log))
    return metrics, arrays


def measure_encoder(store, queries, mesh, device: torch.device,
                    log: Log = log) -> Dict:
    """The encoder's wall texts/s over ``queries`` (best of 3 after a
    first call) and its device texts/s by the slope over a captured
    forward of the 64 median-length chunks of the first 256."""
    from legal_rag_tpu_torch.config import RetrievalConfig
    from legal_rag_tpu_torch.models.minilm import minilm_encode
    from legal_rag_tpu_torch.models.wordpiece import pad_and_bucket
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    engine = RetrievalEngine(store, config=RetrievalConfig(), device=device,
                             mesh=mesh)
    encoder = engine.encoder
    t0 = time.time()
    encoder.encode(queries)
    first_s = time.time() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        encoder.encode(queries)
        _sync(device)
        best = min(best, time.time() - t0)
    rate = len(queries) / best
    log(f"encode: first {first_s:.2f}s, steady {best:.4f}s "
        f"({rate:.0f} texts/s)")

    # a representative ingest batch: 64 median-length corpus chunks (the
    # production encode length-sorts, so a steady ingest batch looks like
    # this, not like 10-token queries)
    tok, ecfg = encoder.fast_tokenizer, encoder.cfg
    enc = sorted(
        (np.asarray(tok.encode(c["text"], max_len=ecfg.max_len), np.int32)
         for c in store.chunks[:256]),
        key=len,
    )
    mid = len(enc) // 2
    enc = enc[max(mid - Q_BATCH // 2, 0): mid + Q_BATCH // 2]
    ids, mask = pad_and_bucket(enc, ecfg.max_len, tok.pad_id)
    dev = encoder.device
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        replay, _ = capture(
            lambda: minilm_encode(encoder.model, ids_t, mask_t), device)
        enc_dt = measure_slope(replay, device, *ENCODE_R, log=log)
    dev_rate = ids.shape[0] / enc_dt
    log(f"encode device texts/s (slope): {dev_rate:.0f} ({enc_dt*1e3:.3f} "
        f"ms/batch-{ids.shape[0]} of {ids.shape[1]} tokens)")
    return {"encode_texts_per_s": rate, "encode_texts_per_s_device": dev_rate,
            "encode_batch_shape": list(ids.shape)}


def record(metrics: Dict) -> Dict:
    """The stdout record: the JAX bench's keys and rounding."""
    dev_qps, cpu_qps = metrics["dev_qps"], metrics["cpu_qps"]
    return {"metric": METRIC, "value": round(dev_qps, 1), "unit": "qps",
            "vs_baseline": round(dev_qps / cpu_qps, 2)}


def run(device="cuda", store_dir: Optional[str] = None,
        chunks: Optional[str] = None, log: Log = log, slope_r=SLOPE_R):
    """Load (``store_dir``) or build the store, measure (``slope_r``: the
    two run lengths of the slopes), log the diagnostics as one JSON line
    and print the record last on stdout. Returns ``(metrics, arrays)``
    as :func:`measure` does."""
    from legal_rag_tpu_torch.index.store import VectorStore

    if store_dir is not None:
        store = VectorStore.load(store_dir)
        source = f"store {store_dir}"
        log(f"index loaded: n={store.n_docs} dim={store.dim}")
    else:
        store, source = build_store(chunks, device=device, log=log)
    log(f"corpus: {source}")
    metrics, arrays = measure(store, device=device, source=source, log=log,
                              slope_r=slope_r)
    log(json.dumps(metrics))
    print(json.dumps(record(metrics)), flush=True)
    return metrics, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", default=None,
                    help="a built store (default: build one under "
                         ".bench_cache/torch_store)")
    ap.add_argument("--chunks", default=None,
                    help="a chunks json to build from (default: the "
                         "synthetic corpus)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false; this bench "
              "needs a CUDA card", file=sys.stderr)
        return 1
    run(store_dir=args.store, chunks=args.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
