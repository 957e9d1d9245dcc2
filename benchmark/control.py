"""The control of a cell's comparison: the plain reference put in the
program's place with every matmul in TF32, the precision below the
configuration's float32 with TF32 off. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs at the cell's own size, draws
as many batches or requests as a run judges from the cell's own traffic,
and reads the comparison's numbers for the control's outputs beside
their limits. Not part of a run: the numbers and the limits set from
them are in PERF.md.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(workload: str, seed: int, device="cuda",
                    overrides=None, mix_overrides=None):
    """``(numbers, limits, correct)`` of the control on one seed."""
    import numpy as np

    from benchmark import harness, judge
    from benchmark.data.weights import stream_seed
    from benchmark.traffic import generator as gen

    _, _, config, mix = harness.cell(workload)
    config.update(overrides or {})
    mix.update(mix_overrides or {})
    data = importlib.import_module(f"benchmark.data.{config['data']}")
    inputs = data.make(config, seed, device)
    ref = judge.Reference(inputs, config, device)
    rng = np.random.default_rng(stream_seed(seed, "traffic"))
    if mix["loop"] == "closed":
        batches = gen.make_batches(mix, inputs, rng)[:mix.get("judged", 8)]
        records = judge.control_records(ref, batches, k=mix["k"],
                                        mode=config["retrieval"]["fusion"]["mode"])
    else:
        queries, _ = gen.form_queries(mix["queries"], mix.get("judged", 64), rng)
        records = judge.control_records(ref, [], requests=queries)
    numbers = judge.judge(ref, *records)
    limits = judge.limits_for(workload)
    correct, _ = judge.verdict(numbers, limits)
    return numbers, limits, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, limits, correct = control_numbers(args.workload, seed)
        print("control " + json.dumps({"workload": args.workload,
                                       "seed": seed, "correct": correct,
                                       "numbers": numbers,
                                       "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
