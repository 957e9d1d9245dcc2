"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison read
beside its limit); the checks are also the last lines of standard error.
The run needs a CUDA card: without one, or with fewer than the cell
asks for, it exits with code 2 and prints no result. It exits with code
3 if JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the port's libraries must not pull JAX in through a third party
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

# The host side of a run is one process with few threads and an
# allocator that keeps what it has: torch, OpenMP and the BLAS run one
# CPU thread each (set before numpy and torch start their pools), and
# glibc's malloc neither moves its mmap threshold nor trims the heap, so
# the program's per-batch buffers are reused rather than mapped and
# faulted in anew each batch.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def fix_allocator() -> None:
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(-3, 32 << 20)      # M_MMAP_THRESHOLD, fixed
    libc.mallopt(-1, 1 << 30)       # M_TRIM_THRESHOLD


fix_allocator()

FORBIDDEN = ("jax", "jaxlib", "flax", "legal_rag_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``legal_rag_tpu_torch`` is the port)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from benchmark import harness

    _, wl, _, _ = harness.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_START)
    result.pop("_diag", None)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
