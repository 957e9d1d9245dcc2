"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the reference and the metrics.

Everything the run does is found by name from ``BENCHMARK.json``: the
cell's configuration file (``configs/<config>.json``, whose ``data``
names the generator in ``data/``), its traffic mix
(``traffic/<traffic>.json``, read by ``traffic/generator.py``), its
limits (``limits/``) and each per-layer metric's reader
(``layers/<metric>.py``, else ``layers/<metric up to its first dot>.py``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def cell(workload: str, manifest: Optional[Dict] = None):
    """``(manifest, workload entry, configuration, traffic mix)``."""
    manifest = manifest or load_json(MANIFEST)
    wl = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / entry["file"])
    mix = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return manifest, wl, config, mix


def reader(metric: str) -> Callable:
    """The per-layer metric's reader, by file name."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "layers" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark.layers._{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for per-layer metric {metric!r}")


def reservoir(rng: np.random.Generator, keep: int):
    """A seeded reservoir's decision for the i-th item: the slot it
    takes, or None."""
    lock = threading.Lock()
    seen = [0]

    def slot() -> Optional[int]:
        with lock:
            i = seen[0]
            seen[0] += 1
            if i < keep:
                return i
            j = int(rng.integers(i + 1))
            return j if j < keep else None
    return slot


@dataclasses.dataclass
class BatchWork:
    q_real: int
    k: int
    postings: int
    token_lengths: List[int]


class LayerContext:
    """What the per-layer readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_ms(self, name: str) -> Optional[float]:
        st = self.stages.get(name)
        if not st or st["count"] <= 0:
            return None
        return 1e3 * st["total_s"] / st["count"]

    def counter_delta(self, name: str) -> float:
        return self.counters_after.get(name, 0) - self.counters_before.get(name, 0)


def stage_delta(before: Dict, after: Dict) -> Dict:
    out = {}
    for name, st in after.items():
        b = before.get(name, {"count": 0, "total_s": 0.0})
        out[name] = {"count": st["count"] - b["count"],
                     "total_s": st["total_s"] - b["total_s"]}
    return out


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def log(msg: str) -> None:
    print(msg, flush=True)


def host_state() -> str:
    """The host as the run sees it: the CPUs it may use and torch's CPU
    threads."""
    import torch

    return (f"cpus {len(os.sched_getaffinity(0))}, torch threads "
            f"{torch.get_num_threads()}")


def corpus_facts(inputs) -> str:
    """What the store holds, measured from the inputs."""
    lens = np.asarray(inputs.bm25_lengths)
    out = (f"{inputs.n_docs} docs, BM25 vocabulary {len(inputs.bm25_vocab)} "
           f"terms, BM25 tokens a doc mean {float(lens.mean()):.2f} max "
           f"{int(lens.max())}, WordPiece vocabulary {len(inputs.wp_vocab)}")
    if inputs.n_docs <= 100_000:
        chars = np.array([len(c["text"]) for c in inputs.chunks])
        out += (f", characters a chunk mean {float(chars.mean()):.1f} max "
                f"{int(chars.max())}")
    return out


# -- warm-up -----------------------------------------------------------------

def l_bucket(ref_tok, text: str, max_len: int) -> int:
    n = len(ref_tok.encode(text, max_len=max_len))
    return min(max_len, max(32, 1 << (n - 1).bit_length()))


def warm_closed(ret, batches, k, ref_tok, max_len):
    """One batch of each (postings budget, token length) key the
    batches take."""
    from benchmark import program

    seen = {}
    for i, qs in enumerate(batches):
        key = (program.postings_budget(ret, qs),
               max(l_bucket(ref_tok, q, max_len) for q in qs))
        seen.setdefault(key, i)
    for key, i in sorted(seen.items()):
        ret.search_batch(batches[i], k=k)
    return sorted(seen)


def warm_open(eng, ret, variants, config, ref_tok, k):
    """Every text the mix can send, once; then coalesced batches of each
    bucket (8-64 queries), fusion mode, postings budget and token length
    that concurrent requests can make."""
    from benchmark import program
    from benchmark.reference import orchestration as orch

    for v in variants:
        eng.query(v, k=k)
    r, ce = config["retrieval"], config["cross_encoder"]
    texts = []
    for v in variants:
        _, searches = orch.plan(v, r["fusion"], r["max_expanded_queries"], k,
                                ce["candidates"])
        for qs, _, _, _ in searches:
            texts.extend(qs)
    texts = list(dict.fromkeys(texts))
    max_len = config["encoder"]["max_len"]
    info = {t: (program.postings_budget(ret, [t]), l_bucket(ref_tok, t, max_len))
            for t in texts}
    filler = min(texts, key=lambda t: info[t])
    k_fetch = max(k, ce["candidates"])
    keys = set(info.values())
    for q_pad in (8, 16, 32, 64):
        n = max(1, q_pad // 2 + 1) if q_pad > 8 else 1
        for mode in (r["fusion"]["mode"], "weighted"):
            for b, l in sorted(keys):
                lead = [t for t, (bb, ll) in info.items() if bb == b and ll == l]
                batch = (lead[:1] + [filler] * n)[:n]
                weights = [0.0 if mode == "weighted" else 0.5] * len(batch)
                ret.search_batch(batch, k=k_fetch, hybrid_weights=weights,
                                 mode=mode)
    return sorted(keys)


def warm_loop(eng, pool, workers, mix, variants, rng, k):
    """The open loop's own workers warmed before the window: each of the
    pool's threads serves a request, all at once, and then the mix runs
    on them for ``warm_s`` seconds at its rate, on queries of its own
    seeded stream, so that the window's first requests meet threads,
    allocator arenas and caches that the loop has already used."""
    from benchmark.traffic import generator as gen

    order = rng.permutation(len(variants))
    gen.warm_pool(pool, workers, lambda i: eng.query(
        variants[int(order[i % len(order)])], k=k))
    warm_s = float(mix.get("warm_s", 0.0))
    if warm_s > 0:
        due = gen.schedule(mix["rate_qps"], warm_s, rng)
        queries, _ = gen.form_queries(mix["queries"], len(due), rng)
        res = gen.run_open(lambda text, i: eng.query(text, k=k), queries,
                           due, workers, pool=pool)
        lat = res.latency_s
        log(f"warm-up loop: {len(lat)} requests over {warm_s} s, p50 "
            f"{1e3 * float(np.median(lat)):.3f} ms")


# -- the run -----------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             overrides: Optional[Dict] = None,
             mix_overrides: Optional[Dict] = None,
             mutate: Optional[Callable] = None) -> Dict:
    """Run one cell once; returns the result line's object and the
    checks. ``overrides``, ``mix_overrides``: configuration and traffic
    keys replaced (the tests' small stores); ``mutate(eng, ret)``: a fault planted in the program before
    the window (the tests of the comparison)."""
    import torch

    from benchmark import judge, program
    from benchmark.data.weights import stream_seed
    from benchmark.reference.wordpiece import WordPieceTokenizer
    from benchmark.traffic import generator as gen

    t0 = t_process if t_process is not None else time.perf_counter()
    manifest, wl, config, mix = cell(workload)
    config.update(overrides or {})
    mix.update(mix_overrides or {})
    if trace:
        os.environ["LEGAL_RAG_PROFILE"] = "1"
    on_card = torch.device(device).type == "cuda"
    data = importlib.import_module(f"benchmark.data.{config['data']}")
    inputs = data.make(config, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    store = program.build_store(inputs, config)
    eng, ret = program.make_engine(mix["entry"], store, config, device)
    if mutate is not None:
        mutate(eng, ret)
    rng = np.random.default_rng(stream_seed(seed, "traffic"))
    ref_tok = WordPieceTokenizer(inputs.wp_vocab)
    max_len = config["encoder"]["max_len"]
    k = mix["k"]

    if mix["loop"] == "closed":
        batches = gen.make_batches(mix, inputs, rng)
        keys = warm_closed(ret, batches, k, ref_tok, max_len)
    else:
        spec = mix["queries"]
        variants = gen.form_variants(spec)
        keys = warm_open(eng, ret, variants, config, ref_tok, k)
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_workers(mix))
        warm_loop(eng, pool, _workers(mix), mix, variants,
                  np.random.default_rng(stream_seed(seed, "warm")), k)
        due = gen.schedule(mix["rate_qps"], seconds, rng)
        queries, form_of = gen.form_queries(spec, len(due), rng)
    log(f"warm-up keys (postings budget, token length): {keys}")
    log(f"corpus: {corpus_facts(inputs)}")
    before = program.counters(ret)
    stages_before = ret.timer.snapshot()
    rec = program.Recorder(eng, ret, np.random.default_rng(
        stream_seed(seed, "sample")), keep=mix.get("judged_encodes", 16))
    tracer = None
    if trace:
        from benchmark.trace import Tracer
        tracer = Tracer()
    pick = reservoir(np.random.default_rng(stream_seed(seed, "judged")),
                     mix.get("judged", 8))
    kept: Dict[int, tuple] = {}
    if on_card:
        log(f"nvidia-smi before the window: {nvidia_smi()}")
    # set-up's objects leave the collector's view, so that collections
    # in the window walk only what the window makes
    gc.collect()
    gc.freeze()
    log(f"host: {host_state()}")
    setup_s = time.perf_counter() - t0
    rec.on = True
    out: Dict = {}
    if mix["loop"] == "closed":
        sent: List[int] = []
        trace_span = [None, None]
        trace_s = min(mix.get("trace_s", 4.0), seconds)

        def on_batch(i, t):
            if tracer is None:
                return
            if trace_span[0] is None and (i >= 1 or t > 0.2 * seconds):
                tracer.start()
                trace_span[0] = (i, time.perf_counter())
            elif trace_span[0] is not None and trace_span[1] is None and \
                    time.perf_counter() - trace_span[0][1] >= trace_s:
                tracer.stop()
                trace_span[1] = i

        def send(qs, i):
            slot = pick()
            r = rec.request() if slot is not None else None
            try:
                ret.search_batch(qs, k=k)
            finally:
                rec.done()
            sent.append(i)
            if r is not None:
                kept[slot] = (i, r)

        res = gen.run_closed(send, batches, seconds, on_batch)
        if tracer is not None and trace_span[1] is None:
            tracer.stop()
            trace_span[1] = res.batches
        window_s = res.t_last - res.t_first
        attempted, failed = res.queries + res.failed, res.failed
        out["search_qps"] = res.queries / window_s
        log(f"window: {res.batches} batches of {mix['batch']} in "
            f"{window_s:.4f} s; batch s min {min(res.batch_s):.4f} "
            f"median {float(np.median(res.batch_s)):.4f} "
            f"max {max(res.batch_s):.4f}")
        edges = res.t_first + window_s * np.arange(1, 6) / 5
        ends = np.searchsorted(np.asarray(res.t_done), edges, side="right")
        per = np.diff(np.concatenate([[0], ends])) * mix["batch"]
        log(f"queries/s by fifth of the window: "
            f"{[round(float(x) / (window_s / 5), 1) for x in per]}")
    else:
        per_form = max(1, mix.get("judged", 64) // len(mix["queries"]["forms"]))
        picks = {f: reservoir(np.random.default_rng(
            stream_seed(seed, f"judged{f}")), per_form)
            for f in set(form_of)}

        def call(text, i):
            slot = picks[form_of[i]]()
            r = rec.request() if slot is not None else None
            try:
                result = eng.query(text, k=k)
            finally:
                rec.done()
            if r is not None:
                kept[(form_of[i], slot)] = (text, r, {
                    "context_used": result["context_used"]})

        at = []
        if tracer is not None:
            t_on = 0.25 * seconds
            at = [(t_on, tracer.start),
                  (min(seconds, t_on + mix.get("trace_s", 4.0)), tracer.stop)]
        try:
            res = gen.run_open(call, queries, due, _workers(mix),
                               at_times=at, pool=pool)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        if tracer is not None:
            tracer.stop()
        lat = res.latency_s
        done = np.isfinite(lat)
        failed = int((~done).sum())
        attempted = len(queries)
        window_s = res.t_end - res.t_start
        if done.all():
            out["query_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
            out["query_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        fifth = max(1, len(lat) // 5)
        diag = {"offered_qps": mix["rate_qps"],
                "completed_qps": float(done.sum()) / window_s,
                "p50_first_fifth_ms": 1e3 * float(np.median(lat[:fifth])),
                "p50_last_fifth_ms": 1e3 * float(np.median(lat[-fifth:]))}
        log(f"open loop: {json.dumps(diag)}")
        log(f"window: {attempted} requests due over {seconds} s at "
            f"{mix['rate_qps']} /s, {int(done.sum())} done, last done "
            f"{window_s:.4f} s after the first was due; generator late "
            f"by max {1e3 * float(res.late_s.max()):.3f} ms, mean "
            f"{1e3 * float(res.late_s.mean()):.3f} ms")
    rec.on = False
    if on_card:
        torch.cuda.synchronize()
        log(f"nvidia-smi after the window: {nvidia_smi()}")
    after = program.counters(ret)
    stages = stage_delta(stages_before, ret.timer.snapshot())
    captures = after.get("graphs", 0) - before.get("graphs", 0)
    log(f"program counters before the window: {json.dumps(before)}")
    log(f"program counters after the window: {json.dumps(after)}")
    log(f"stages over the window: {json.dumps(stages)}")
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    reading = tracer.read() if tracer is not None else None
    out["setup_s"] = setup_s

    # the program's state goes before the reference runs
    encodes = list(rec.encodes)
    if mix["loop"] == "closed":
        calls = [c for _, (_, r) in sorted(kept.items()) for c in r["search"]]
        requests = []
    else:
        requests = [v for _, v in sorted(kept.items())]
        calls = [c for _, r, _ in requests for c in r["search"]]
    del rec, eng, ret, store
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = judge.Reference(inputs, config, device)
    numbers = judge.judge(ref, encodes, calls, requests)
    limits = judge.limits_for(workload)
    correct, checks = judge.verdict(numbers, limits)
    correct = correct and failed == 0 and captures == 0
    if captures:
        log(f"{captures} graphs were captured inside the window")

    metrics: Dict[str, Dict] = {}
    wanted = manifest["per_layer"] if trace else manifest["end_to_end"]
    if trace:
        # the profiler's start and stop are not the program's time
        ctx = _layer_context(config, mix, inputs, ref, stages, before, after,
                             reading, window_s - tracer.overhead_s,
                             requests_done=int(attempted - failed),
                             batches=batches if mix["loop"] == "closed" else None,
                             sent=sent if mix["loop"] == "closed" else [],
                             traced=trace_span if mix["loop"] == "closed"
                             else None, k=k)
    for m in wanted:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        if trace:
            v = reader(m["name"])(ctx)
        else:
            v = out.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name() if on_card
                         else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if reading is not None:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.stretch_s
        result["breakdown"] = {"device_ops": reading.top_ops(),
                               "idle_gaps": reading.idle_gaps()}
        log(f"kernel seconds by host span: {dict(reading.kernel_span)}")
    if not trace:
        log(f"end-to-end: {json.dumps(out)}")
    result["checks"] = checks
    if mix["loop"] == "open":
        result["_diag"] = dict(diag, **out)
    return result


def _workers(mix: Dict) -> int:
    from benchmark.traffic import generator as gen

    w = mix.get("workers", "server_default")
    return gen.server_default_workers() if w == "server_default" else int(w)


def _layer_context(config, mix, inputs, ref, stages, before, after, reading,
                   window_s, requests_done, batches, sent, traced, k):
    work: Dict[int, BatchWork] = {}

    def batch_work(i: int) -> BatchWork:
        j = i % len(batches)
        if j not in work:
            qs = batches[j]
            post = [ref.bm25.n_postings(q) for q in qs]
            cap = ref.cap
            work[j] = BatchWork(
                q_real=len(qs), k=k,
                postings=sum(min(p, cap) if cap else p for p in post),
                token_lengths=[len(ref.encoder.token_ids(q)) for q in qs])
        return work[j]

    window_batches = [batch_work(i) for i in sent] if batches else []
    traced_batches = []
    if batches and traced and traced[0] is not None:
        i0, i1 = traced[0][0], traced[1]
        traced_batches = [batch_work(i) for i in sent if i0 <= i < i1]
    dtype_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}.get(
        config["retrieval"]["dense_dtype"], 4)
    return LayerContext(
        config=config, mix=mix, stages=stages, counters_before=before,
        counters_after=after, trace=reading, window_s=window_s,
        requests_done=requests_done, window_batches=window_batches,
        traced_batches=traced_batches, n_docs=inputs.n_docs,
        dim=int(inputs.embeddings.shape[1]), doc_bytes=dtype_bytes)
