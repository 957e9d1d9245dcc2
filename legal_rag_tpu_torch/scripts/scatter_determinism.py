"""Is the BM25 scatter the same on every run? The fp32 ``scatter_add_``
against ``ops.sparse.bm25_score_batch`` (the fixed-point sum), on the
card.

A batch of 64 queries' postings at the headline bench's budget (16,384)
over 2,620 docs, drawn from ``--seed``: each way of summing runs
``--runs`` times eagerly and ``--runs`` times as a replay of one CUDA
graph; the script counts the runs whose ``[64, 2,620]`` scores differ
in any bit from the first eager run's, and times a call by CUDA events.
One JSON line, the card's name and power limit in it.

Usage:  python -m legal_rag_tpu_torch.scripts.scatter_determinism
            [--runs 200] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

Q, P, N = 64, 16_384, 2620


def differing(fn, ref, runs: int) -> int:
    return sum(not torch.equal(fn(), ref) for _ in range(runs))


def measure(name: str, fn, runs: int) -> dict:
    from legal_rag_tpu_torch.utils.timing import time_ms

    ref = fn()
    eager = differing(fn, ref, runs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()

    def replay():
        graph.replay()
        return out.clone()

    return {"name": name, "runs": runs, "eager_differing": eager,
            "replays_differing": differing(replay, ref, runs),
            "max_abs_diff": float((fn() - ref).abs().max()),
            "ms": time_ms(fn, iters=100, warmup=10)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scatter_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    from legal_rag_tpu_torch.ops.sparse import bm25_score_batch

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(
        rng.integers(0, N + 1, (Q, P)).astype(np.int32)).to(dev)
    w = torch.from_numpy(
        rng.gamma(2.0, 1.0, (Q, P)).astype(np.float32)).to(dev)

    def fp32():
        s = torch.zeros((Q, N + 1), device=dev)
        s.scatter_add_(1, ids.long(), w)
        return s[:, :N]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "shape": [Q, P, N], "rows": [
        measure("fp32 scatter_add_", fp32, args.runs),
        measure("bm25_score_batch (fixed point)",
                lambda: bm25_score_batch(ids, w, N), args.runs)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
