"""The witness to a fault of the program's BM25 segment sums: a traffic
mix's batches served by the program's default path and by its scatter
path, each returned row judged against the plain reference.

    python3 benchmark/witness.py --config legal-1m --traffic search64-rare \\
        --seeds 5100,3000000011 --batches 256

For each seed it makes the configuration's inputs at its own size, builds
one engine a path (``sharded_hybrid_search``'s ``sparse_mode``: ``auto``,
the served default, and ``scatter``), sends the mix's first ``--batches``
distinct batches through each engine's ``search_batch``, and judges with
``reference/search.py``'s tie band every query whose ids differ between
the paths, and every query of the first ``--whole`` batches. It prints
one line a seed: the bands each path needed, and each query that needed
more than rounding. Not part of a run: its readings are in PERF.md.
"""

from __future__ import annotations

import argparse
import functools
import gc
import importlib
import json
import os
import sys
from typing import Dict, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ROUNDING = 1e-7


def witness(config: Dict, mix: Dict, seed: int, n_batches: int,
            whole: int = 2, paths: Sequence[str] = ("auto", "scatter"),
            device="cuda") -> Dict:
    """One seed's readings: the bands each path's rows needed."""
    import numpy as np
    import torch

    from benchmark import judge, program
    from benchmark.data.weights import stream_seed
    from benchmark.reference.search import band_needed
    from benchmark.traffic import generator as gen
    import legal_rag_tpu_torch.retrieval.engine as engine_mod

    data = importlib.import_module(f"benchmark.data.{config['data']}")
    inputs = data.make(config, seed, device)
    store = program.build_store(inputs, config)
    rng = np.random.default_rng(stream_seed(seed, "traffic"))
    batches = gen.make_batches(mix, inputs, rng)[:n_batches]
    k = mix["k"]
    served = engine_mod.sharded_hybrid_search
    rows: Dict[str, list] = {}
    try:
        for path in paths:
            engine_mod.sharded_hybrid_search = functools.partial(
                served, sparse_mode=path)
            _, ret = program.make_engine("search_batch", store, config,
                                         device)
            rows[path] = [[[(r.doc_id, r.score, r.semantic, r.keyword)
                            for r in row] for row in ret.search_batch(qs, k=k)]
                          for qs in batches]
            del ret
            gc.collect()
    finally:
        engine_mod.sharded_hybrid_search = served
    del store
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = judge.Reference(inputs, config, device)
    fu = ref.fusion
    bands = {p: {} for p in paths}
    wide, differ = [], 0
    for b, qs in enumerate(batches):
        for qi, q in enumerate(qs):
            got = [rows[p][b][qi] for p in paths]
            same = all([r[0] for r in g] == [r[0] for r in got[0]]
                       for g in got)
            differ += not same
            if same and b >= whole:
                continue
            ch = ref.channels(q)
            need = [band_needed(ch, g, fu["mode"], k, ref.c_of(k),
                                fu["rrf_k"], fu["hybrid_weight"]) for g in got]
            for p, n in zip(paths, need):
                bands[p][n] = bands[p].get(n, 0) + 1
            if max(need) > ROUNDING:
                wide.append([b, qi, *need, ref.bm25.n_postings(q)])
    return {"seed": seed, "batches": len(batches),
            "queries": sum(len(qs) for qs in batches), "ids_differ": differ,
            "whole_batches": min(whole, len(batches)),
            "bands": {p: sorted(h.items()) for p, h in bands.items()},
            "wide": wide}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=256)
    ap.add_argument("--whole", type=int, default=2)
    args = ap.parse_args(argv)

    from benchmark import harness, run  # noqa: F401  (a run's process settings)

    config = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    mix = harness.load_json(harness.HERE / "traffic" / f"{args.traffic}.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = witness(config, mix, seed, args.batches, args.whole)
        print("witness " + json.dumps(dict(config=args.config,
                                           traffic=args.traffic, **out)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
