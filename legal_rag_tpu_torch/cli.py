"""Command line of the port, the JAX package's subcommands and flags:

    python -m legal_rag_tpu_torch ingest   --docs DIR --out chunks.json
    python -m legal_rag_tpu_torch build    --source DIR_OR_JSON --store DIR
    python -m legal_rag_tpu_torch search   --store DIR --query "..." [--k 5]
    python -m legal_rag_tpu_torch serve    --store DIR [--port 8000]
    python -m legal_rag_tpu_torch finetune --store DIR --out tuned.npz
    python -m legal_rag_tpu_torch convert  --checkpoint model.bin --out params.npz

``build``, ``search``, ``serve`` and ``finetune`` run on the card
unless ``--device cpu`` says otherwise. A store built here or by the
JAX package serves in either. ``serve`` warms the serving path up and
serves the HTTP API of ``legal_rag_tpu_torch.server.app`` with the
port's engine injected; it honours ``LEGAL_RAG_NO_RERANK=1`` (serve
without the cross-encoder) and ``LEGAL_RAG_NO_COALESCE=1`` (one device
dispatch per request) as the JAX server does, and ``--dense-dtype
{float32,bfloat16,int8,pq}`` (or ``LEGAL_RAG_DENSE_DTYPE``) picks the
dense storage tier. The evaluation subcommands (``eval``,
``eval-gate``, ``eval-retrieval``) are not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
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


def _cmd_ingest(args) -> int:
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.pipeline import law_counts

    chunks = parse_corpus(args.docs)
    data = []
    for c in chunks:
        d = c.to_reference_dict()
        d["section_id"] = c.section_id
        data.append(d)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)
    if args.debug_dump:
        # human-auditable dry-run dump (reference
        # ingest_legal_docs.py:300-307 writes debug_chunks.txt)
        with open(args.debug_dump, "w", encoding="utf-8") as f:
            for i, (c, d) in enumerate(zip(chunks, data)):
                meta = {
                    k: v for k, v in d.get("metadata", {}).items()
                    if v is not None
                }
                f.write(f"--- CHUNK {i+1} ---\n")
                f.write(f"METADATA: {json.dumps(meta, ensure_ascii=False)}\n")
                f.write(f"CONTENT:\n{d['text']}\n\n")
        print(f"debug dump -> {args.debug_dump}")
    print(f"{len(chunks)} chunks -> {args.out}")
    for law, count in law_counts(chunks).items():
        print(f"  {law}: {count}")
    return 0


def _cmd_build(args) -> int:
    from legal_rag_tpu_torch.index.builder import build_index
    from legal_rag_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    store = build_index(
        args.source,
        store_dir=args.store,
        finetune_steps=args.finetune_steps,
        finetune_token_weight=args.finetune_token_weight,
        finetune_augment=args.finetune_augment,
        finetune_augment_kinds=args.finetune_augment_kinds,
        pq_m=args.pq_m,
        ivf_cell_size=args.ivf_cell_size,
        rerank_steps=args.rerank_steps,
        rerank_sibling_prob=args.rerank_sibling_prob,
        multi_vector=args.multi_vector,
        log_fn=(
            print
            if (args.finetune_steps or args.pq_m or args.rerank_steps
                or args.multi_vector or args.ivf_cell_size)
            else None
        ),
        device=args.device,
        timer=timer,
    )
    print(
        f"index built: {store.n_docs} docs x {store.dim}d, "
        f"bm25 vocab {store.bm25.vocab_size} -> {args.store}"
    )
    print("build stages (s): " + ", ".join(
        f"{name} {v['total_s']:.3f}" for name, v in timer.snapshot().items()
    ))
    return 0


def _cmd_search(args) -> int:
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store = VectorStore.load(args.store)
    engine = RetrievalEngine(store, device=args.device)
    if args.mode:
        rows = engine.search_batch(
            [args.query], k=args.k, hybrid_weights=[args.weight],
            mode=args.mode,
        )[0]
        results = [r.to_dict() for r in rows]
    else:
        results = engine.search(
            args.query, k=args.k, hybrid_weight=args.weight
        )
    for i, r in enumerate(results, 1):
        header = r["chunk"]["canonical_header"].replace("\n", " | ")
        print(
            f"[{i}] score={r['score']:.4f} sem={r['semantic']:.4f} "
            f"kw={r['keyword']:.4f}  {header}"
        )
    return 0


def _cmd_serve(args) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    from legal_rag_tpu_torch.server.app import run_server

    engine = load_engine(args.store, args.device, args.dense_dtype)
    asyncio.run(run_server(engine=engine, host=args.host, port=args.port))
    return 0


def _cmd_finetune(args) -> int:
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.models.convert import save_params_npz
    from legal_rag_tpu_torch.models.finetune import finetune_encoder
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store = VectorStore.load(args.store)
    engine = RetrievalEngine(store, device=args.device)
    tuned, losses = finetune_encoder(
        engine.encoder,
        [c["text"] for c in store.chunks],
        steps=args.steps,
        batch_size=args.batch,
        learning_rate=args.lr,
        log_fn=print,
        chunks=store.chunks,
    )
    save_params_npz(tuned.params, args.out)
    print(
        f"fine-tuned {args.steps} steps "
        f"(loss {losses[0]:.3f} -> {losses[-1]:.3f}); params -> {args.out}\n"
        f"rebuild the index with these weights to serve them."
    )
    return 0


def _cmd_convert(args) -> int:
    """Convert an HF BertModel checkpoint to the npz params."""
    import torch

    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.models.convert import (
        convert_hf_bert, save_params_npz,
    )

    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    params = convert_hf_bert(sd, EncoderConfig())
    save_params_npz(params, args.out)
    print(f"converted {args.checkpoint} -> {args.out}")
    return 0


def _positive(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return iv


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device for the encoders and the index "
                        "(default cuda; cpu runs without a card)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="legal_rag_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ingest", help="parse legal markdown into chunks")
    p.add_argument("--docs", required=True)
    p.add_argument("--out", default="legal_chunks.json")
    p.add_argument(
        "--debug-dump", default="debug_chunks.txt",
        help="human-auditable chunk dump (reference "
             "ingest_legal_docs.py:300-307); '' disables",
    )
    p.set_defaults(fn=_cmd_ingest)

    p = sub.add_parser("build", help="build the vector store")
    p.add_argument("--source", required=True,
                   help="documents dir or chunks json")
    p.add_argument("--store", required=True)
    p.add_argument(
        "--finetune-steps", type=int, default=0,
        help="contrastive encoder fine-tune steps before encoding "
             "(0 = off)",
    )
    p.add_argument(
        "--pq-m", type=int, default=0,
        help="train product-quantization codebooks with m subspaces "
             "(m bytes/doc; 0 = off) so serving can use the "
             "dense.dtype='pq' capacity tier without boot-time k-means",
    )
    p.add_argument(
        "--ivf-cell-size", type=int, default=0, dest="ivf_cell_size",
        help="with --pq-m: cluster the corpus into balanced cells of "
             "this many docs for IVF coarse pruning (0 = off)",
    )
    p.add_argument(
        "--rerank-steps", type=int, default=0, dest="rerank_steps",
        help="train the cross-encoder reranker and persist it if it "
             "passes the held-out gate (0 = off)",
    )
    p.add_argument(
        "--finetune-token-weight", type=float, default=0.0,
        dest="finetune_token_weight", metavar="W",
        help="blend a token-level late-interaction InfoNCE term into "
             "the encoder finetune (0 = the pooled-only recipe)",
    )
    p.add_argument(
        "--finetune-augment", type=float, default=0.0,
        dest="finetune_augment", metavar="P",
        help="probability a finetune query span is augmented (register "
             "substitution / word dropout / unique-token rebuild); 0 = off",
    )
    p.add_argument(
        "--finetune-augment-kinds", default="",
        dest="finetune_augment_kinds", metavar="K1,K2",
        help="restrict the augmentation mix to a comma-separated subset "
             "of register,dropout,unique (with --finetune-augment)",
    )
    p.add_argument(
        "--rerank-sibling-prob", type=float, default=0.0,
        dest="rerank_sibling_prob", metavar="P",
        help="probability a CE training group's positive is a sibling "
             "chunk of the span's section (0 = the span/title recipe)",
    )
    p.add_argument(
        "--multi-vector", type=int, default=0, metavar="TOKEN_BUDGET",
        help="persist per-chunk token embeddings (first N WordPiece "
             "tokens) for the late-interaction tier; 0 = off",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_build)

    p = sub.add_parser("search", help="query a store from the CLI")
    p.add_argument("--store", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--weight", type=float, default=0.5)
    p.add_argument(
        "--mode", default=None,
        choices=["weighted", "rrf", "maxsim", "maxsim-rerank"],
        help="fusion/scoring mode (default: config fusion mode; "
             "maxsim/maxsim-rerank need a store built with "
             "--multi-vector)",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_search)

    p = sub.add_parser("serve", help="serve the HTTP API")
    p.add_argument("--store", required=True, help="store directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--dense-dtype", default=None, choices=DENSE_DTYPES,
        help="dense storage tier: exact fp32 (default), bf16 (2x less "
             "device memory), int8 (4x, exact via rescore), or pq (32x, "
             "build the store with --pq-m first). Env equivalent: "
             "LEGAL_RAG_DENSE_DTYPE",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser(
        "finetune", help="contrastively adapt the encoder to the corpus"
    )
    p.add_argument("--store", required=True)
    p.add_argument("--out", default="encoder_tuned.npz")
    p.add_argument("--steps", type=_positive, default=200)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-5)
    _add_device(p)
    p.set_defaults(fn=_cmd_finetune)

    p = sub.add_parser(
        "convert", help="convert an HF BertModel state_dict to npz params"
    )
    p.add_argument("--checkpoint", required=True,
                   help="path to pytorch_model.bin / .pt state_dict")
    p.add_argument("--out", default="encoder_params.npz")
    p.set_defaults(fn=_cmd_convert)

    args = parser.parse_args(argv)
    return args.fn(args)
