"""Command line of the port, the JAX package's subcommands and flags:

    python -m legal_rag_tpu_torch ingest   --docs DIR --out chunks.json
    python -m legal_rag_tpu_torch build    --source DIR_OR_JSON --store DIR
    python -m legal_rag_tpu_torch search   --store DIR --query "..." [--k 5]
    python -m legal_rag_tpu_torch serve    --store DIR [--port 8000]
    python -m legal_rag_tpu_torch eval     --store DIR [--report out.json]
    python -m legal_rag_tpu_torch eval-gate --store DIR [--max-queries N]
    python -m legal_rag_tpu_torch eval-retrieval --store DIR [--include-pq]
    python -m legal_rag_tpu_torch finetune --store DIR --out tuned.npz
    python -m legal_rag_tpu_torch convert  --checkpoint model.bin --out params.npz

Every subcommand but ``ingest`` and ``convert`` runs on the card
unless ``--device cpu`` says otherwise. A store built here or by the
JAX package serves in either. ``serve`` warms the serving path up and
serves the HTTP API of ``legal_rag_tpu_torch.server.app`` with the
port's engine injected; it honours ``LEGAL_RAG_NO_RERANK=1`` (serve
without the cross-encoder) and ``LEGAL_RAG_NO_COALESCE=1`` (one device
dispatch per request) as the JAX server does, and ``--dense-dtype
{float32,bfloat16,int8,pq}`` (or ``LEGAL_RAG_DENSE_DTYPE``) picks the
dense storage tier. ``eval`` writes its report to
``build/quality_report.json`` unless ``--report`` names another file,
so a run from the repository root leaves its ``quality_report*.json``
alone; ``eval``, ``eval-gate`` and ``eval-retrieval`` exit 1 when a
gate fails, as the JAX package's do.
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
    """The serving engine, warmed up (its CUDA graphs captured for the
    buckets the warm-up queries touch), with request coalescing unless
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
    if engine.engine.graphs is not None:
        # the buckets the warmup touched are captured, as the JAX
        # server's warmup compiles them
        logger.info("%s", engine.engine.graphs.summary())
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


def _cmd_eval(args) -> int:
    from legal_rag_tpu_torch.quality import run_quality_eval

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
    report = run_quality_eval(
        args.store, report_path=args.report,
        include_paraphrase=args.include_paraphrase, device=args.device,
    )
    passed = sum(1 for r in report["results"] if r["passed"])
    print(f"quality eval: {passed}/{len(report['results'])} passed")
    ok = passed == len(report["results"])
    if args.include_paraphrase:
        para = report["paraphrase"]
        print(
            f"paraphrase gate: {para['passed']}/{para['total']} grounded "
            f"(threshold {para['threshold']}) -> "
            f"{'PASS' if para['gate_passed'] else 'FAIL'}"
        )
        ok = ok and para["gate_passed"]
    return 0 if ok else 1


def _cmd_eval_gate(args) -> int:
    """Big-split retrieval gate: pinned serving thresholds over the
    structure + sibling-span splits (quality.py
    RETRIEVAL_GATE_THRESHOLDS)."""
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.quality import run_retrieval_gate

    store = VectorStore.load(args.store)
    report = run_retrieval_gate(
        store, max_queries=args.max_queries, report_path=args.report,
        device=args.device,
    )
    for c in report["checks"]:
        status = "PASS" if c["passed"] else "FAIL"
        print(
            f"  [{status}] {c['split']}/{c['mode']} {c['metric']}: "
            f"{c['measured']:.4f} (floor {c['threshold']})"
        )
    print(f"retrieval gate: {'PASS' if report['gate_passed'] else 'FAIL'}")
    return 0 if report["gate_passed"] else 1


def _cmd_eval_retrieval(args) -> int:
    """Retrieval-quality recall@k over corpus-structure queries, per
    mode (dense/bm25/weighted/rrf); optionally the random-vs-fine-tuned
    encoder ablation or a cross-encoder trained for the run."""
    from legal_rag_tpu_torch.evaluation import (
        compare_encoders, evaluate_store, labeled_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    store = VectorStore.load(args.store)

    def show(title, modes):
        print(title)
        for mode, m in modes.items():
            cells = "  ".join(f"{k}={v:.3f}" for k, v in m.items())
            print(f"  {mode:<9} {cells}")

    if args.rerank_steps:
        from legal_rag_tpu_torch.evaluation import evaluate_rerank
        from legal_rag_tpu_torch.models.cross_encoder import (
            CrossEncoder, train_cross_encoder,
        )

        engine = RetrievalEngine(store, device=args.device)
        ce = CrossEncoder(engine.encoder)
        train_cross_encoder(
            ce, [c["text"] for c in store.chunks],
            steps=args.rerank_steps, log_fn=print,
        )
        pairs = labeled_pairs_from_chunks(
            store.chunks, max_pairs=args.max_pairs
        )
        print(f"{len(pairs)} labeled structure queries")
        report = evaluate_rerank(store, pairs, ce, engine=engine)
        show(f"rerank over {report['base_mode']} top-"
             f"{report['candidates']}:", report["modes"])
    elif args.finetune_steps:
        report = compare_encoders(
            store.chunks,
            finetune_steps=args.finetune_steps,
            max_pairs=args.max_pairs,
            log_fn=print,
            device=args.device,
        )
        show("random-init encoder:", report["random_encoder"])
        show("fine-tuned encoder:", report["finetuned_encoder"])
    else:
        from legal_rag_tpu_torch.evaluation import (
            sibling_span_pairs_from_chunks,
        )
        from legal_rag_tpu_torch.quality import _provenance

        pairs = labeled_pairs_from_chunks(
            store.chunks, max_pairs=args.max_pairs
        )
        print(f"{len(pairs)} labeled structure queries")
        modes = ["dense", "bm25", "weighted", "rrf"]
        if args.include_pq:
            modes.append("pq")   # capacity-tier candidate coverage
        if args.include_maxsim:
            # full-scan + capacity-safe dense-first variants
            modes.extend(["maxsim", "maxsim-rerank"])
        engine = RetrievalEngine(store, device=args.device)
        report = evaluate_store(
            store, pairs, modes=tuple(modes), engine=engine
        )
        show("store encoder (structure/title split):", report["modes"])

        # paraphrase split: a natural span from one chunk of a
        # multi-chunk section retrieves the section's OTHER chunks
        # (source masked)
        para = sibling_span_pairs_from_chunks(
            store.chunks, max_pairs=args.max_pairs
        )
        print(f"{len(para)} sibling-span (paraphrase) queries")
        para_report = evaluate_store(
            store, para, modes=tuple(m for m in modes if m != "pq"),
            engine=engine,
        )
        show("store encoder (paraphrase/sibling-span split):",
             para_report["modes"])
        report = {
            "structure": report,
            "paraphrase": para_report,
            "provenance": _provenance(engine),
        }
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.report}")
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
        engine.mesh,
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

    p = sub.add_parser("eval", help="run the quality gate")
    p.add_argument("--store", required=True)
    p.add_argument("--report", default=os.path.join("build",
                                                    "quality_report.json"))
    p.add_argument(
        "--include-paraphrase", action="store_true",
        help="also run the 10-query paraphrase grounding gate "
             "(serving stores must ground >= the pinned threshold; "
             "untrained stores are expected to fail it)",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_eval)

    p = sub.add_parser(
        "eval-gate",
        help="big-split retrieval gate with pinned serving thresholds "
             "(structure RRF + sibling dense recall floors)",
    )
    p.add_argument("--store", required=True)
    p.add_argument("--report", default=None)
    p.add_argument(
        "--max-queries", type=int, default=None,
        help="cap each split (CI / smoke runs); serving gate runs full",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_eval_gate)

    p = sub.add_parser(
        "eval-retrieval",
        help="recall@k per retrieval mode over corpus-structure queries",
    )
    p.add_argument("--store", required=True)
    p.add_argument("--report", default=None)
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument(
        "--finetune-steps", type=int, default=0,
        help="also run the random-vs-fine-tuned encoder ablation",
    )
    p.add_argument(
        "--rerank-steps", type=int, default=0,
        help="train a cross-encoder reranker for N steps and report "
             "base-vs-reranked recall/MRR",
    )
    p.add_argument(
        "--include-pq", action="store_true",
        help="also score the PQ capacity tier (dense-only through the "
             "4-bit codes + rescore)",
    )
    p.add_argument(
        "--include-maxsim", action="store_true",
        help="also score the late-interaction (MaxSim) tier; needs a "
             "store built with --multi-vector",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_eval_retrieval)

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
