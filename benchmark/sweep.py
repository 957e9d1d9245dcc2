"""Find the knee of an open-loop cell: the highest offered rate at which
completions keep pace with arrivals and no backlog grows.

    python3 benchmark/sweep.py --workload legal-2620.query-open --seed 7 \\
        --seconds 20 --rates 10,20,30,40,50

Each rate runs the cell's own set-up, warm-up, loop and comparison
(``harness.run_cell`` with the rate replaced), in this one process. A
rate keeps pace when the completed rate is within 5% of the offered one
and the median latency of the last fifth of the requests is under twice
that of the first fifth. Prints one line a rate and the knee. Not a
cell: the knee it finds is written into the mix's ``rate_qps`` at 4/5.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def keeps_pace(d) -> bool:
    return (d["completed_qps"] >= 0.95 * d["offered_qps"]
            and d["p50_last_fifth_ms"] < 2.0 * d["p50_first_fifth_ms"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True,
                    help="offered rates, requests a second, comma-separated")
    args = ap.parse_args(argv)

    from benchmark import run  # noqa: F401  (a run's process settings)

    import torch

    from benchmark import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        res = harness.run_cell(args.workload, args.seed, args.seconds, False,
                               mix_overrides={"rate_qps": rate})
        d = dict(res.pop("_diag"), correct=res["correct"],
                 failed=res["failed"], pace=None)
        d["pace"] = keeps_pace(d)
        print("sweep " + json.dumps(d), flush=True)
        if d["pace"] and res["correct"]:
            knee = rate
    print(f"knee {knee} requests/s; the cell's rate at 4/5: "
          f"{None if knee is None else round(0.8 * knee, 3)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
