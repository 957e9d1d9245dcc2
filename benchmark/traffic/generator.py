"""The one traffic generator: reads a mix's parameter file and drives
the program's entry with it.

Query kinds (``queries.kind`` in the mix's file):

- ``forms``: request texts from templates with slots, each form equally
  often and each form's variants in turn, the same texts for every seed
  in the seed's order (a frozen copy of ``scripts/bench_http.py``'s
  eight query forms, with variants);
- ``chunk_words``: 3-8 consecutive alphabetic words of a random stored
  chunk (a frozen copy of ``bench.py``'s ``sample_queries``);
- ``rare_terms``: a few terms whose frequency rank lies in a band of the
  store's vocabulary.

Loops (``loop``):

- ``closed``: one client sends a batch, waits for it, sends the next,
  until the window closes; the batch under way at the close runs to its
  end and counts;
- ``open``: requests arrive at a fixed rate on a schedule, each run on a
  worker of a pool the size of the server's default executor, and each
  timed from when it was due. The gaps between arrivals are the same
  set for every seed (exponential quantiles), in the seed's order.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


# -- queries -----------------------------------------------------------------

def form_queries(spec: Dict, n: int, rng: np.random.Generator):
    """``(texts, forms)``: ``n`` requests over the forms, each form
    ``n / len(forms)`` times (rounded) and each form's variants in turn,
    so that every seed sends the same requests, in the seed's order;
    ``forms[i]`` is the index of request ``i``'s form."""
    forms = spec["forms"]
    variants = [form_variants({"forms": [form]}) for form in forms]
    which = np.arange(n) % len(forms)
    taken = [0] * len(forms)
    texts = []
    for f in which:
        texts.append(variants[f][taken[f] % len(variants[f])])
        taken[f] += 1
    order = rng.permutation(n)
    return [texts[i] for i in order], [int(which[i]) for i in order]


def form_variants(spec: Dict) -> List[str]:
    """Every text the forms can make (the warm-up sends each once)."""
    out = []
    for form in spec["forms"]:
        texts = [form["template"]]
        for slot, vals in form["slots"].items():
            texts = [t.replace("{" + slot + "}", v, 1)
                     for t in texts for v in vals]
        out.extend(texts)
    return out


def chunk_word_queries(spec: Dict, chunks, n: int,
                       rng: np.random.Generator) -> List[str]:
    lo, hi = spec["min_words"], spec["max_words"]
    out = []
    for _ in range(n):
        text = chunks[int(rng.integers(len(chunks)))]["text"]
        words = [w for w in text.split() if w.isalpha()]
        take = int(rng.integers(lo, hi + 1))
        if len(words) >= take:
            at = int(rng.integers(0, len(words) - take + 1))
            out.append(" ".join(words[at:at + take]))
        else:
            out.append("punishment for robbery under section")
    return out


def rare_term_queries(spec: Dict, ranked_words: Sequence[str], n: int,
                      rng: np.random.Generator) -> List[str]:
    lo = spec["rank_lo"] - 1
    hi = min(spec["rank_hi"], len(ranked_words))
    out = []
    for _ in range(n):
        m = int(rng.integers(spec["min_terms"], spec["max_terms"] + 1))
        out.append(" ".join(ranked_words[int(r)]
                            for r in rng.integers(lo, hi, size=m)))
    return out


def make_batches(mix: Dict, inputs, rng: np.random.Generator):
    """The closed loop's distinct batches, sent in turn."""
    spec = mix["queries"]
    n = mix["batch"] * mix["distinct_batches"]
    if spec["kind"] == "chunk_words":
        qs = chunk_word_queries(spec, inputs.chunks, n, rng)
    elif spec["kind"] == "rare_terms":
        qs = rare_term_queries(spec, inputs.ranked_words, n, rng)
    else:
        raise ValueError(f"query kind {spec['kind']!r} is not a batch kind")
    b = mix["batch"]
    return [qs[i:i + b] for i in range(0, n, b)]


def schedule(rate: float, seconds: float, rng: np.random.Generator):
    """Due times in ``[0, seconds)``: ``round(rate * seconds)`` arrivals
    whose gaps are the exponential distribution's quantiles at
    ``(i + 0.5) / n``, scaled to fill the window, in a seeded order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due


def server_default_workers() -> int:
    """asyncio's default executor, which the HTTP server runs requests
    on: ``min(32, cpu_count + 4)``."""
    return min(32, (os.cpu_count() or 1) + 4)


# -- loops -------------------------------------------------------------------

class ClosedResult:
    def __init__(self):
        self.batches = 0
        self.queries = 0
        self.failed = 0
        self.t_first = None
        self.t_last = None
        self.batch_s: List[float] = []
        self.t_done: List[float] = []


def run_closed(send: Callable[[List[str], int], None], batches, seconds: float,
               on_batch: Optional[Callable[[int, float], None]] = None
               ) -> ClosedResult:
    """``send(queries, index)`` batch after batch until ``seconds`` have
    passed since the first send; ``on_batch(index, now)`` runs between
    batches (the tracer's stretch starts and stops there)."""
    res = ClosedResult()
    res.t_first = time.perf_counter()
    deadline = res.t_first + seconds
    i = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if on_batch is not None:
            on_batch(i, now - res.t_first)
        qs = batches[i % len(batches)]
        t0 = time.perf_counter()
        try:
            send(qs, i)
            res.queries += len(qs)
        except Exception as e:  # noqa: BLE001 — a failed batch is counted
            res.failed += len(qs)
            print(f"batch {i} failed: {e!r}", flush=True)
        t1 = time.perf_counter()
        res.batch_s.append(t1 - t0)
        res.t_done.append(t1)
        res.batches += 1
        i += 1
    if on_batch is not None:
        on_batch(i, time.perf_counter() - res.t_first)
    res.t_last = time.perf_counter()
    return res


class OpenResult:
    def __init__(self, n: int):
        self.latency_s = np.full(n, np.inf)     # inf: failed or never done
        self.late_s = np.zeros(n)
        self.t_start = None
        self.t_end = None


def warm_pool(pool: concurrent.futures.ThreadPoolExecutor, workers: int,
              fn: Callable[[int], None]) -> None:
    """Every one of the pool's ``workers`` threads started and running
    ``fn(i)`` at once (each waits for the others first), so that the
    window finds no thread that has not served a request."""
    barrier = threading.Barrier(workers)

    def one(i: int):
        barrier.wait(timeout=120)
        fn(i)

    list(pool.map(one, range(workers)))


def run_open(call: Callable[[str, int], None], queries: Sequence[str],
             due: np.ndarray, workers: int, grace_s: float = 60.0,
             at_times: Sequence = (),
             pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
             ) -> OpenResult:
    """Each request ``call(text, index)`` submitted when due; its latency
    from due time to completion. ``at_times``: ``(offset_s, fn)`` run by
    the dispatcher once the window reaches each offset. ``pool``: the
    workers to run on (left running), else a pool of ``workers`` made
    for this loop and shut down after it."""
    res = OpenResult(len(queries))
    pending = sorted(at_times, key=lambda x: x[0])

    def one(i: int, due_at: float):
        try:
            call(queries[i], i)
            res.latency_s[i] = time.perf_counter() - due_at
        except Exception as e:  # noqa: BLE001 — a failed request is counted
            print(f"request {i} failed: {e!r}", flush=True)

    own = pool is None
    if own:
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    futures = []
    try:
        res.t_start = t0 = time.perf_counter()
        for i, d in enumerate(due):
            while pending and pending[0][0] <= d:
                pending.pop(0)[1]()
            target = t0 + float(d)
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            res.late_s[i] = max(0.0, time.perf_counter() - target)
            futures.append(pool.submit(one, i, target))
        for _, fn in pending:
            fn()
        done, not_done = concurrent.futures.wait(
            futures, timeout=max(grace_s, 0.0)
            + max(0.0, t0 + float(due[-1]) - time.perf_counter()))
        for f in done:
            f.result()
        res.t_end = time.perf_counter()
    finally:
        if own:
            pool.shutdown(wait=True, cancel_futures=True)
    return res
