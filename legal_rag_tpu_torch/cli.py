"""Command line: ``python -m legal_rag_tpu_torch serve --store DIR``.

Loads a store built by the JAX package (``python -m legal_rag_tpu
build``), warms the serving path up, and serves the HTTP API of
``legal_rag_tpu_torch.server.app`` with the port's engine injected. Honours
``LEGAL_RAG_NO_RERANK=1`` (serve without the cross-encoder) and
``LEGAL_RAG_NO_COALESCE=1`` (one device dispatch per request) as the
JAX server does. ``--dense-dtype {float32,bfloat16,int8,pq}`` (or
``LEGAL_RAG_DENSE_DTYPE``) picks the dense storage tier.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import socket
import threading
import time
from typing import Optional, Sequence

logger = logging.getLogger("legal-rag-torch.cli")

# one short informational query and one victim query with concept
# expansion and stopword-heavy postings: together they touch every
# stage of the serving path before the first user request
WARMUP_QUERIES = (
    "What is the procedure to file an FIR?",
    "I was robbed at gunpoint just now, what is the procedure and what "
    "are the rights of the victim?",
)


DENSE_DTYPES = ("float32", "bfloat16", "int8", "pq")


def serving_config(dense_dtype: Optional[str] = None):
    """The default retrieval config with the dense storage tier set by
    ``dense_dtype``, else by ``LEGAL_RAG_DENSE_DTYPE``, else unchanged."""
    from legal_rag_tpu_torch.config import DEFAULT_CONFIG

    dtype = dense_dtype or os.environ.get("LEGAL_RAG_DENSE_DTYPE")
    if not dtype:
        return DEFAULT_CONFIG
    if dtype not in DENSE_DTYPES:
        raise ValueError(f"dense dtype {dtype!r} not in {DENSE_DTYPES}")
    return dataclasses.replace(
        DEFAULT_CONFIG,
        dense=dataclasses.replace(DEFAULT_CONFIG.dense, dtype=dtype),
    )


def load_engine(store_dir: str, device: str, dense_dtype: Optional[str] = None):
    """The serving engine, warmed up, with request coalescing unless
    ``LEGAL_RAG_NO_COALESCE=1``."""
    from legal_rag_tpu_torch.server.source_fetcher import set_default_catalog
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine

    rerank = False if os.environ.get("LEGAL_RAG_NO_RERANK", "") == "1" else None
    engine = LegalEngine(store_dir=store_dir, rerank=rerank, device=device,
                         config=serving_config(dense_dtype))
    set_default_catalog(engine.engine.store.chunks)
    t0 = time.time()
    for q in WARMUP_QUERIES:
        engine.query(q)
    logger.info("warmup complete in %.1fs", time.time() - t0)
    if os.environ.get("LEGAL_RAG_NO_COALESCE", "") != "1":
        engine.engine.enable_request_coalescing()
    return engine


class BackgroundServer:
    """The HTTP server on its own event loop in a daemon thread, for
    callers that drive it from the same process (tests, smoke runs)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        from legal_rag_tpu_torch.server.app import run_server

        if port == 0:
            with socket.socket() as s:
                s.bind((host, 0))
                port = s.getsockname()[1]
        self.host, self.port = host, port
        self._loop = asyncio.new_event_loop()
        self._startup_error: Optional[BaseException] = None
        ready = threading.Event()

        async def serve():
            bound = asyncio.Event()
            server = asyncio.ensure_future(run_server(
                engine=engine, host=host, port=port, ready_event=bound))
            waiter = asyncio.ensure_future(bound.wait())
            await asyncio.wait({server, waiter},
                               return_when=asyncio.FIRST_COMPLETED)
            waiter.cancel()
            if server.done() and not server.cancelled():
                self._startup_error = server.exception()
            ready.set()
            if self._startup_error is None:
                await server

        def run():
            asyncio.set_event_loop(self._loop)
            self._task = self._loop.create_task(serve())
            try:
                self._loop.run_until_complete(self._task)
            except asyncio.CancelledError:   # stop() cancels the server
                pass

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(timeout=60):
            raise RuntimeError("HTTP server did not start within 60 s")
        if self._startup_error is not None:
            raise RuntimeError("HTTP server failed to start") from (
                self._startup_error
            )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._task.cancel)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError("HTTP server thread did not stop")
        self._loop.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="legal_rag_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="serve the HTTP API")
    serve.add_argument("--store", required=True, help="store directory")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--device", default="cuda",
                       help="torch device for the encoders and the index")
    serve.add_argument(
        "--dense-dtype", default=None, choices=DENSE_DTYPES,
        help="dense storage tier: exact fp32 (default), bf16 (2x less "
             "device memory), int8 (4x, exact via rescore), or pq (32x, "
             "build the store with --pq-m first). Env equivalent: "
             "LEGAL_RAG_DENSE_DTYPE",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    from legal_rag_tpu_torch.server.app import run_server

    engine = load_engine(args.store, args.device, args.dense_dtype)
    asyncio.run(run_server(engine=engine, host=args.host, port=args.port))
    return 0
