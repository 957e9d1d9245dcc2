"""HTTP serving latency of the port: ``POST /api/v1/query`` p50/p99
through the real server under 1 / 16 / 64 concurrent clients, with and
without the request coalescer and the cross-encoder. The counterpart of
the JAX package's ``scripts/bench_http.py``, with its queries, clients
and report.

Each client holds ONE keep-alive connection and issues sequential
requests (closed loop), so concurrency == in-flight requests. Mixed
query forms (procedural / victim / informational) exercise the
classifier, concept expansion, CE rerank and the responder.

Each pass starts ``python -m legal_rag_tpu_torch serve --store S --port
P --device DEV`` in a process group of its own (``LEGAL_RAG_NO_COALESCE``
and ``LEGAL_RAG_NO_RERANK`` set for the uncoalesced and no-rerank
passes), polls ``/health`` until ready, warms every query form, runs
each level, then stops the server by signalling its process group,
never by pattern. The report's provenance names the torch device the
server ran on (``platform`` ``"gpu"`` and the card's name and count on
a CUDA card).

Usage:
  python -m legal_rag_tpu_torch.scripts.bench_http --store DIR
      [--port 8123] [--requests 40] [--concurrency 1,16,64]
      [--no-coalesce-pass] [--no-rerank-pass] [--device cuda|cpu]
      [--report PATH] [--server-log PATH]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]

QUERIES = [
    "What is the procedure to file an FIR electronically?",
    "I was robbed at gunpoint just now, what do I do?",
    "What is the punishment for robbery under BNS?",
    "How much compensation can an acid attack victim get?",
    "What is a Zero FIR?",
    "Someone threw a corrosive liquid at my cousin's face",
    "Is rape a bailable offence?",
    "Which sections of BNSS deal with medical examination of victims?",
]


def wait_ready(port: int, proc: Optional[subprocess.Popen] = None,
               timeout_s: float = 600.0) -> None:
    """Poll ``/health`` until the engine is ready; raise if the server
    process exits first or the time runs out."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"server exited {proc.returncode} before ready")
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            if body.get("engine_status") == "ready":
                return
        except Exception:  # noqa: BLE001 — server still booting
            pass
        time.sleep(1)
    raise TimeoutError(f"server not ready after {timeout_s}s")


def client_loop(port: int, n: int, offset: int, out: list,
                errors: list) -> None:
    """Sequential requests on one keep-alive connection. Failures
    (timeouts at saturation, non-200s) are COUNTED, not raised — a
    stack that can't sustain the level should report that as data."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=180)
    for i in range(n):
        q = QUERIES[(offset + i) % len(QUERIES)]
        body = json.dumps({"query": q}).encode()
        t0 = time.perf_counter()
        try:
            conn.request(
                "POST", "/api/v1/query", body,
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                errors.append(f"{resp.status}: {data[:120]!r}")
                continue
            out.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — saturation timeouts
            errors.append(f"{type(e).__name__}: {e}")
            conn.close()
            conn = http.client.HTTPConnection(
                "127.0.0.1", port, timeout=180
            )
    conn.close()


def run_level(port: int, concurrency: int, n_per_client: int) -> dict:
    threads, results = [], []
    errors: list = []
    t0 = time.perf_counter()
    for c in range(concurrency):
        out: list = []
        results.append(out)
        th = threading.Thread(
            target=client_loop,
            args=(port, n_per_client, c * 3, out, errors),
        )
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    lat = sorted(x for out in results for x in out)
    row = {
        "concurrency": concurrency,
        "n_requests": len(lat),
        "n_errors": len(errors),
    }
    if errors:
        row["error_sample"] = errors[0]
    if not lat:
        return row

    def pct(p):
        return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

    row.update({
        "p50_ms": round(pct(50) * 1e3, 2),
        "p90_ms": round(pct(90) * 1e3, 2),
        "p99_ms": round(pct(99) * 1e3, 2),
        "mean_ms": round(sum(lat) / len(lat) * 1e3, 2),
        "qps": round(len(lat) / wall, 1),
    })
    return row


def start_server(store: str, port: int, no_coalesce: bool,
                 no_rerank: bool = False, device: str = "cuda",
                 log_path: str = os.devnull) -> subprocess.Popen:
    """``serve`` in a new session (its own process group), output to
    ``log_path``."""
    env = dict(os.environ)
    for var, on in (("LEGAL_RAG_NO_COALESCE", no_coalesce),
                    ("LEGAL_RAG_NO_RERANK", no_rerank)):
        if on:
            env[var] = "1"
        else:
            env.pop(var, None)
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "legal_rag_tpu_torch", "serve", "--store",
             store, "--host", "127.0.0.1", "--port", str(port), "--device",
             device],
            cwd=REPO_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )


def stop_server(proc: subprocess.Popen) -> None:
    """SIGTERM the server's process group; SIGKILL it after 20 s."""
    os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=20)


def provenance(device: str) -> Dict:
    """The device the server ran on, as ``quality._provenance`` names
    it."""
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "n_devices": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1}


def run(store: str, port: int = 8123, requests: int = 40,
        levels: Sequence[int] = (1, 16, 64), no_coalesce_pass: bool = False,
        no_rerank_pass: bool = False, device: str = "cuda",
        log=print, server_log: str = os.devnull) -> Dict:
    """Every pass at every level; the JAX script's report."""
    passes = [("coalesced", False, False)]
    if no_coalesce_pass:
        passes.append(("uncoalesced", True, False))
    if no_rerank_pass:
        passes.append(("no_rerank", False, True))

    report: Dict = {"store": store, "passes": {}}
    for name, no_coal, no_rr in passes:
        proc = start_server(store, port, no_coal, no_rr, device, server_log)
        try:
            wait_ready(port, proc)
            # warm every query form (victim queries expand to a 4-wide
            # batch, informational ones stay single) before timing
            run_level(port, 1, 2 * len(QUERIES))
            rows: List[Dict] = []
            for c in levels:
                row = run_level(port, c, requests)
                log(f"[{name}] c={c}: p50 {row.get('p50_ms')} ms "
                    f"p99 {row.get('p99_ms')} ms qps {row.get('qps')} "
                    f"errors {row['n_errors']}")
                rows.append(row)
            report["passes"][name] = rows
        finally:
            stop_server(proc)
        time.sleep(1)
    report["provenance"] = provenance(device)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--requests", type=int, default=40,
                    help="requests per client per level")
    ap.add_argument("--concurrency", default="1,16,64")
    ap.add_argument("--no-coalesce-pass", action="store_true",
                    help="additionally measure with coalescing disabled")
    ap.add_argument("--no-rerank-pass", action="store_true",
                    help="additionally measure without the CE stage")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    ap.add_argument("--server-log", default=os.devnull,
                    help="append the servers' output to this file")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench_http: torch.cuda.is_available() is false; serving on "
              "the card needs a CUDA card (--device cpu serves on the CPU)",
              file=sys.stderr)
        return 1
    report = run(args.store, args.port, args.requests,
                 [int(x) for x in args.concurrency.split(",")],
                 args.no_coalesce_pass, args.no_rerank_pass, args.device,
                 log=lambda s: print(s, flush=True),
                 server_log=args.server_log)
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
