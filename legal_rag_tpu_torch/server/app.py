"""HTTP serving layer.

Mirrors the reference FastAPI app's contract (reference
src/server/app.py): the server binds immediately while the engine loads
in a background thread; ``GET /health`` reports the
loading/ready/error tri-state; ``POST /api/v1/query`` returns the
structured legal response (503 while loading, 500 on engine errors);
CORS allow-all. Adds ``GET /rag/source`` (verbatim source fetch, the
ghost capability) and per-stage latency metrics in /health.

Implemented on asyncio's stream server directly — this image has no
fastapi/uvicorn, and the handler surface is 3 routes; the engine call
runs in a worker thread so the event loop keeps serving /health during
long queries (the reference blocks its event loop here, SURVEY.md §3.1).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger("legal-rag-tpu.server")

_CORS_HEADERS = (
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Methods", "*"),
    ("Access-Control-Allow-Headers", "*"),
)

# request bodies are a single query string; anything huge is abuse
_MAX_BODY_BYTES = 1 << 20


class EngineHost:
    """Background-loading engine holder (reference app.py:47-70)."""

    def __init__(
        self, store_dir: Optional[str] = None, engine=None, config=None,
    ):
        self.store_dir = store_dir
        self.engine = engine
        self.config = config          # RetrievalConfig override (e.g.
                                      # the dense storage tier); None =
                                      # framework defaults
        self.loading = engine is None
        self.error: Optional[str] = None
        self.coalescer = None
        self._thread: Optional[threading.Thread] = None

    def start_loading(self) -> None:
        if self.engine is not None or self._thread is not None:
            self.loading = self.engine is None and self.error is None
            return
        self._thread = threading.Thread(target=self._load, daemon=True)
        self._thread.start()

    def _load(self) -> None:
        try:
            logger.info("background engine load starting")
            from legal_rag_tpu_torch.retrieval.facade import LegalEngine
            from legal_rag_tpu_torch.server.source_fetcher import set_default_catalog

            # LEGAL_RAG_NO_RERANK=1 serves without the cross-encoder
            # precision stage even when the store carries a checkpoint
            # — the CE forward is ~5 s/query on a CPU backend
            # (BASELINE.md round-5 HTTP table), so CPU deployments of
            # a TPU-built store want it off; None keeps auto-enable
            rerank = (
                False
                if os.environ.get("LEGAL_RAG_NO_RERANK", "") == "1"
                else None
            )
            if self.config is not None:
                engine = LegalEngine(
                    store_dir=self.store_dir, config=self.config,
                    rerank=rerank,
                )
            else:
                engine = LegalEngine(
                    store_dir=self.store_dir, rerank=rerank
                )
            set_default_catalog(engine.engine.store.chunks)
            # Warmup: drive one representative query through the full
            # pipeline while /health still reports "loading" — jit
            # compilation (minutes on remote-compile TPU setups) must
            # not land on the first user request.
            logger.info("warmup queries starting (jit compile)")
            t0 = time.time()
            # two warmups: a short informational query and a victim
            # query with concept expansion + stopword-heavy postings —
            # together they compile every (batch, budget) bucket the
            # serving path uses
            engine.query("What is the procedure to file an FIR?")
            engine.query(
                "I was robbed at gunpoint just now, what is the "
                "procedure and what are the rights of the victim?"
            )
            logger.info("warmup complete in %.1fs", time.time() - t0)
            # coalesce concurrent requests' searches into shared device
            # dispatches (after warmup, so compiles never serialize
            # behind the window). LEGAL_RAG_NO_COALESCE=1 serves each
            # request as its own dispatch (A/B lever for the HTTP load
            # benchmark, scripts/bench_http.py)
            if os.environ.get("LEGAL_RAG_NO_COALESCE", "") != "1":
                self.coalescer = engine.engine.enable_request_coalescing()
            self.engine = engine
            logger.info("background engine load complete")
        except Exception as e:  # noqa: BLE001 — surfaced via /health
            logger.exception("engine load failed")
            self.error = str(e)
        finally:
            self.loading = False

    @property
    def status(self) -> str:
        if self.loading:
            return "loading"
        return "ready" if self.engine else "error"


def _response_payload(result: Dict[str, Any]) -> Dict[str, Any]:
    """Engine dict -> the reference LegalResponseModel shape
    (reference app.py:120-141)."""
    raw = result["response"]
    return {
        "answer": raw.get("answer", ""),
        "safety_alert": raw.get("safety_alert"),
        "immediate_action_plan": raw.get("immediate_action_plan", []),
        "legal_basis": raw.get("legal_basis", ""),
        "procedure_steps": raw.get("procedure_steps", []),
        "important_notes": raw.get("important_notes", []),
        "sources": [
            {
                "law": s.get("law", "Unknown"),
                "section": s.get("section", "Unknown"),
                "citation": s.get("citation", "Unknown"),
                "text": s.get("content", ""),
            }
            for s in raw.get("sources", [])
        ],
        "metadata": result.get("intent", {}),
        "context_used": result.get("context_used", []),
        "adapted": result.get("adapted"),
        # additive over the reference's LegalResponseModel (which drops
        # it): a legal-advice API must surface the non-advisory
        # disclaimer the responder generates and the quality gate pins
        "disclaimer": raw.get("disclaimer", ""),
    }


class HttpApp:
    def __init__(self, host: EngineHost):
        self.host = host
        self.timer_totals: Dict[str, float] = {}

    # -- routing -----------------------------------------------------------

    async def handle(
        self, method: str, path: str, query: Dict[str, str], body: bytes
    ) -> Tuple[int, Dict[str, Any]]:
        if method == "OPTIONS":
            return 204, {}
        if method == "GET" and path == "/health":
            return self._health()
        if method == "POST" and path == "/api/v1/query":
            return await self._query(body)
        if method == "POST" and path == "/api/v1/batch_search":
            return await self._batch_search(body)
        if method == "GET" and path == "/rag/source":
            return self._source(query)
        return 404, {"detail": "not found"}

    def _health(self) -> Tuple[int, Dict[str, Any]]:
        payload: Dict[str, Any] = {
            "status": "ok" if self.host.engine else "starting",
            "engine_status": self.host.status,
            "error": self.host.error,
        }
        if self.host.engine is not None:
            payload["stage_latency"] = (
                self.host.engine.engine.timer.snapshot()
            )
            coal = getattr(self.host.engine.engine, "_coalescer", None)
            if coal is not None:
                payload["coalescing"] = {
                    "requests": coal.requests,
                    "device_dispatches": coal.dispatches,
                }
        return 200, payload

    async def _query(self, body: bytes):
        if self.host.loading:
            return 503, {"detail": "Legal Engine is still loading. Please wait."}
        if not self.host.engine:
            return 503, {
                "detail": f"Legal Engine failed to load: {self.host.error}"
            }
        try:
            request = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return 400, {"detail": "invalid JSON body"}
        query_text = request.get("query")
        if not query_text or not isinstance(query_text, str):
            return 422, {"detail": "field 'query' (string) is required"}

        mode = request.get("fusion_mode")
        if mode not in (None, "weighted", "rrf"):
            return 422, {"detail": "fusion_mode must be 'weighted' or 'rrf'"}

        if request.get("stream"):
            # staged SSE: intent + retrieved context as soon as the
            # device search returns, the generated answer when ready
            # (the reference accepts this flag but never implements
            # it, reference app.py:28)
            return "stream", self._query_stream(query_text, mode)

        start = time.time()
        try:
            result = await asyncio.get_event_loop().run_in_executor(
                None,
                lambda: self.host.engine.query(query_text, mode=mode),
            )
        except Exception as e:  # noqa: BLE001 — 500 with detail
            logger.exception("query failed")
            return 500, {"detail": str(e)}
        logger.info("query processed in %.2fs", time.time() - start)
        return 200, _response_payload(result)

    async def _batch_search(self, body: bytes):
        """Raw batched retrieval: many queries, one device program —
        the arrays-as-interface core exposed directly (no LLM stages).
        Body: {"queries": [...], "k": 5, "fusion_mode": "weighted"}
        (fusion_mode also accepts the late-interaction "maxsim" /
        "maxsim-rerank" on stores built with --multi-vector)."""
        if self.host.loading:
            return 503, {"detail": "Legal Engine is still loading. Please wait."}
        if not self.host.engine:
            return 503, {
                "detail": f"Legal Engine failed to load: {self.host.error}"
            }
        try:
            request = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return 400, {"detail": "invalid JSON body"}
        queries = request.get("queries")
        if (
            not isinstance(queries, list)
            or not queries
            or not all(isinstance(s, str) and s for s in queries)
        ):
            return 422, {
                "detail": "field 'queries' (non-empty list of strings) "
                "is required"
            }
        if len(queries) > 256:
            return 422, {"detail": "at most 256 queries per batch"}
        k = request.get("k", 5)
        if not isinstance(k, int) or not 1 <= k <= 100:
            return 422, {"detail": "k must be an int in [1, 100]"}
        mode = request.get("fusion_mode")
        if mode not in (None, "weighted", "rrf", "maxsim", "maxsim-rerank"):
            return 422, {
                "detail": "fusion_mode must be 'weighted', 'rrf', "
                "'maxsim' or 'maxsim-rerank'"
            }
        engine = self.host.engine.engine  # the RetrievalEngine core
        if mode in ("maxsim", "maxsim-rerank") and (
            engine.store.mv_tokens is None
        ):
            return 422, {
                "detail": "store has no multi-vector artifacts; rebuild "
                "with `build --multi-vector <token_budget>` to serve "
                "late-interaction modes"
            }
        if mode == "maxsim-rerank" and engine.config.dense.dtype not in (
            "float32", "bfloat16"
        ):
            # rerank_search raises on quantized dense tiers; surface it
            # as the 422 this endpoint's validation contract promises,
            # not a 500 from the engine
            return 422, {
                "detail": "maxsim-rerank needs a float32/bfloat16 dense "
                f"tier for its candidate stage (store serves dtype="
                f"'{engine.config.dense.dtype}'); use fusion_mode "
                "'maxsim' or 'weighted' on quantized tiers"
            }
        try:
            batched = await asyncio.get_event_loop().run_in_executor(
                None,
                lambda: engine.search_batch(queries, k=k, mode=mode),
            )
        except Exception as e:  # noqa: BLE001
            logger.exception("batch search failed")
            return 500, {"detail": str(e)}
        return 200, {
            "results": [
                [
                    {
                        "doc_id": r.doc_id,
                        "score": r.score,
                        "semantic": r.semantic,
                        "keyword": r.keyword,
                        "citation": r.chunk.get("canonical_header"),
                        "section_id": r.chunk.get("section_id"),
                    }
                    for r in rows
                ]
                for rows in batched
            ]
        }

    async def _query_stream(self, query_text: str, mode=None):
        """SSE event generator: orchestration first, answer second."""
        loop = asyncio.get_event_loop()
        engine = self.host.engine
        try:
            orchestration = await loop.run_in_executor(
                None,
                lambda: engine.orchestrator.orchestrate(query_text, mode=mode),
            )
            yield "intent", orchestration["intent"]
            yield "context", [
                {
                    "citation": c["chunk"]["canonical_header"],
                    "section_id": c["chunk"].get("section_id"),
                    "score": c.get("score"),
                }
                for c in orchestration["results"]
            ]
            response = await loop.run_in_executor(
                None,
                lambda: engine.responder.generate_response(
                    query=query_text,
                    context=orchestration["results"],
                    intent=orchestration["intent"],
                ),
            )
            yield "response", response.to_dict()
        except Exception as e:  # noqa: BLE001 — surfaced as an event
            logger.exception("streaming query failed")
            yield "error", {"detail": str(e)}

    def _source(self, query: Dict[str, str]) -> Tuple[int, Dict[str, Any]]:
        from legal_rag_tpu_torch.server.schemas import SourceType
        from legal_rag_tpu_torch.server.source_fetcher import fetch_source_content

        raw_type = query.get("source_type", "")
        section_id = query.get("section_id", "")
        try:
            source_type = SourceType(raw_type)
        except ValueError:
            return 422, {
                "detail": f"unknown source_type {raw_type!r}; one of "
                f"{[t.value for t in SourceType]}"
            }
        result = fetch_source_content(
            source_type, section_id,
            highlight_snippet=query.get("highlight_snippet") or None,
        )
        if result is None:
            return 404, {"detail": f"source {section_id!r} not found"}
        return 200, json.loads(result.model_dump_json())


# keep-alive connections idle out after this many seconds; bounds the
# open-socket count without a connection cap
_KEEPALIVE_IDLE_S = 75.0


async def _serve_connection(app: HttpApp, reader, writer) -> None:
    """Persistent-connection HTTP/1.1 loop: requests are served off one
    socket until the client closes, asks to close, or idles out —
    clients stop paying a TCP handshake per request (the round-1 server
    closed every connection, making the HTTP edge the bottleneck at
    high QPS)."""
    try:
        while True:
            try:
                request_line = await asyncio.wait_for(
                    reader.readline(), timeout=_KEEPALIVE_IDLE_S
                )
            except asyncio.TimeoutError:
                return
            if not request_line:
                return
            try:
                method, target, version = (
                    request_line.decode("latin1").strip().split(" ", 2)
                )
            except ValueError:
                return
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, value = line.decode("latin1").partition(":")
                headers[key.strip().lower()] = value.strip()

            # HTTP/1.1 defaults to keep-alive; 1.0 must opt in
            conn_hdr = headers.get("connection", "").lower()
            keep_alive = (
                "close" not in conn_hdr
                and (version.startswith("HTTP/1.1") or "keep-alive" in conn_hdr)
            )
            conn_line = (
                "Connection: keep-alive" if keep_alive else "Connection: close"
            )

            length = int(headers.get("content-length", "0") or "0")
            if length > _MAX_BODY_BYTES:
                # drain (bounded) before responding: closing mid-send
                # would RST the client before it can read the 413
                remaining = min(length, 64 << 20)
                while remaining > 0:
                    got = await reader.read(min(remaining, 1 << 16))
                    if not got:
                        break
                    remaining -= len(got)
                data = json.dumps(
                    {"detail": "request body too large"}
                ).encode()
                writer.write(
                    (
                        f"HTTP/1.1 413 ERR\r\n"
                        f"Content-Type: application/json\r\n"
                        f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n"
                    ).encode() + data
                )
                await writer.drain()
                return
            body = await reader.readexactly(length) if length else b""

            parsed = urllib.parse.urlsplit(target)
            query = dict(urllib.parse.parse_qsl(parsed.query))
            status, payload = await app.handle(
                method.upper(), parsed.path, query, body
            )

            if status == "stream":
                # Server-Sent Events over chunked transfer; the stream
                # has no delimiter beyond EOF, so it always closes
                lines = [
                    "HTTP/1.1 200 OK",
                    "Content-Type: text/event-stream",
                    "Cache-Control: no-cache",
                    "Transfer-Encoding: chunked",
                    "Connection: close",
                ]
                lines.extend(f"{k}: {v}" for k, v in _CORS_HEADERS)
                writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
                await writer.drain()

                def chunk(data: bytes) -> bytes:
                    return f"{len(data):X}\r\n".encode() + data + b"\r\n"

                async for event, obj in payload:
                    frame = (
                        f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode()
                    )
                    writer.write(chunk(frame))
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
                await writer.drain()
                return

            data = json.dumps(payload).encode() if status != 204 else b""
            lines = [
                f"HTTP/1.1 {status} {'OK' if status < 400 else 'ERR'}",
                "Content-Type: application/json",
                f"Content-Length: {len(data)}",
                conn_line,
            ]
            lines.extend(f"{k}: {v}" for k, v in _CORS_HEADERS)
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + data)
            await writer.drain()
            if not keep_alive:
                return
    except Exception:  # noqa: BLE001 — connection-level robustness
        logger.exception("connection handler error")
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass


async def run_server(
    store_dir: Optional[str] = None,
    host: str = "0.0.0.0",
    port: int = 8000,
    engine=None,
    ready_event: Optional[asyncio.Event] = None,
    config=None,
) -> None:
    engine_host = EngineHost(
        store_dir=store_dir, engine=engine, config=config
    )
    engine_host.start_loading()
    app = HttpApp(engine_host)
    server = await asyncio.start_server(
        lambda r, w: _serve_connection(app, r, w), host, port
    )
    logger.info("serving on %s:%d (engine loading in background)", host, port)
    if ready_event is not None:
        ready_event.set()
    async with server:
        await server.serve_forever()


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    port = int(os.getenv("PORT", "8000"))
    store_dir = os.getenv("LEGAL_RAG_STORE", "data/vector_store")
    config = None
    dtype = os.getenv("LEGAL_RAG_DENSE_DTYPE")
    if dtype:
        import dataclasses

        from legal_rag_tpu_torch.config import DEFAULT_CONFIG

        config = dataclasses.replace(
            DEFAULT_CONFIG,
            dense=dataclasses.replace(DEFAULT_CONFIG.dense, dtype=dtype),
        )
    asyncio.run(run_server(store_dir=store_dir, port=port, config=config))


if __name__ == "__main__":
    main()
