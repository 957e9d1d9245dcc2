"""Index build pipeline: chunks -> embeddings + BM25 -> VectorStore.

The port of ``legal_rag_tpu.index.builder``: the same arguments, the
same resume fingerprint and the same store, with the device work on
``device``: the encoder's fine-tune (``models/finetune.py``), the chunk
embeddings (``SentenceEncoder.encode``), the token slab
(``ops.maxsim.minilm_token_embeddings``), OPQ + PQ and IVF k-means
(``ops/pq.py``), and the cross-encoder's training and held-out gate
through the port's ``RetrievalEngine``. BM25 is built on the host by the
copied ``build_bm25``. Matmuls run in full fp32 (TF32 off), as the JAX
package's build does on the CPU, so a store built on the card agrees
with one built on the CPU.

The fingerprint hashes what the JAX package's does, the encoder's
leaves in ``jax.tree_util``'s order, so a store built by either package
with the same encoder weights has the same ``corpus_hash`` and resumes
in the other. Without an encoder the port initializes its own with
numpy, whose weights differ from the JAX package's random init of the
same seed: that hash carries an init tag, so neither package reuses a
store the other built with other weights.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from legal_rag_tpu_torch.config import RetrievalConfig, DEFAULT_CONFIG
from legal_rag_tpu_torch.ingest import parse_corpus
from legal_rag_tpu_torch.ingest.parser import LegalChunk
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.ops.sparse import build_bm25
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.utils.timing import StageTimer

# hashed in place of encoder weights when the port initializes its own
# encoder (models/minilm.py init_minilm_params, numpy's N(0, 0.02))
DEFAULT_INIT_TAG = "init:numpy-normal0.02"


def _chunk_dicts(chunks: Sequence[Union[LegalChunk, Dict]]) -> List[Dict]:
    out = []
    for c in chunks:
        if isinstance(c, LegalChunk):
            d = c.to_reference_dict()
            d["section_id"] = c.section_id
        else:
            d = dict(c)
            d.setdefault("section_id", None)
        out.append(d)
    return out


def tree_leaves(node) -> List:
    """The leaves of a param pytree in ``jax.tree_util.tree_leaves``'s
    order: dict keys sorted, lists in order."""
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in tree_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [leaf for v in node for leaf in tree_leaves(v)]
    return [node]


def corpus_fingerprint(
    texts: Sequence[str],
    config: RetrievalConfig,
    encoder: Optional[SentenceEncoder],
    finetune_steps: int = 0,
    finetune_token_weight: float = 0.0,
    finetune_augment: float = 0.0,
    finetune_augment_kinds: str = "",
    pq_m: int = 0,
    ivf_cell_size: int = 0,
    rerank_steps: int = 0,
    rerank_sibling_prob: float = 0.0,
    multi_vector: int = 0,
) -> str:
    """The store's ``corpus_hash``: corpus, config, recipe and encoder
    identity, hashed as the JAX package's builder hashes them."""
    h = hashlib.sha256()
    for t in texts:
        h.update(t.encode("utf-8"))
        h.update(b"\x00")
    h.update(repr((config.encoder, config.bm25)).encode())
    if finetune_steps:
        from legal_rag_tpu_torch.models.finetune import SIBLING_PROB_DEFAULT

        ftag = f"finetune:{finetune_steps}:sib{SIBLING_PROB_DEFAULT}"
        if finetune_token_weight:
            ftag += f":tok{finetune_token_weight}"
        if finetune_augment:
            ftag += f":aug{finetune_augment}"
            if finetune_augment_kinds:
                ftag += f":kinds[{finetune_augment_kinds}]"
        h.update(ftag.encode())
    if pq_m:
        h.update(f"pq:{pq_m}:opq8".encode())
    if ivf_cell_size:
        h.update(f"ivf:{ivf_cell_size}".encode())
    if rerank_steps:
        tag = f"rerank:{rerank_steps}:meanpool-hard"
        if rerank_sibling_prob:
            tag += f":sib{rerank_sibling_prob}"
        h.update(tag.encode())
    if multi_vector:
        h.update(f"mv:{multi_vector}".encode())
    if encoder is not None:
        h.update(repr(encoder.cfg).encode())
        h.update(str(getattr(encoder, "seed", 0)).encode())
        for leaf in tree_leaves(encoder.params):
            arr = np.asarray(leaf)
            h.update(arr.shape.__repr__().encode())
            h.update(arr.tobytes()[:4096])
    else:
        h.update(DEFAULT_INIT_TAG.encode())
    return h.hexdigest()


def build_index(
    source,
    encoder: Optional[SentenceEncoder] = None,
    config: RetrievalConfig = DEFAULT_CONFIG,
    store_dir=None,
    finetune_steps: int = 0,
    finetune_token_weight: float = 0.0,
    finetune_augment: float = 0.0,
    finetune_augment_kinds: str = "",
    pq_m: int = 0,
    ivf_cell_size: int = 0,
    rerank_steps: int = 0,
    rerank_sibling_prob: float = 0.0,
    multi_vector: int = 0,
    log_fn=None,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> VectorStore:
    """Build a full index (the JAX package's ``build_index`` documents
    each argument).

    ``source``: a documents directory, a chunks json, or a chunk
    sequence. ``encoder``: defaults to a corpus-vocab encoder with the
    numpy init on ``device``; a given encoder encodes on its own device,
    and everything else runs on ``device``. ``store_dir``: save there,
    or return the store already there when its ``corpus_hash`` matches.
    ``timer``: records each stage's wall time (``ingest``, ``finetune``,
    ``encode``, ``tokens``, ``pq``, ``ivf``, ``bm25``, ``rerank``,
    ``save``).
    """
    timer = timer or StageTimer()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with timer.stage("ingest"):
        if isinstance(source, (str, Path)):
            path = Path(source)
            if path.is_dir():
                chunks = _chunk_dicts(parse_corpus(path))
            else:
                with open(path, "r", encoding="utf-8") as f:
                    chunks = _chunk_dicts(json.load(f))
        else:
            chunks = _chunk_dicts(source)

    texts = [c["text"] for c in chunks]
    corpus_hash = corpus_fingerprint(
        texts, config, encoder, finetune_steps=finetune_steps,
        finetune_token_weight=finetune_token_weight,
        finetune_augment=finetune_augment,
        finetune_augment_kinds=finetune_augment_kinds, pq_m=pq_m,
        ivf_cell_size=ivf_cell_size, rerank_steps=rerank_steps,
        rerank_sibling_prob=rerank_sibling_prob, multi_vector=multi_vector,
    )
    if store_dir is not None:
        manifest_path = Path(store_dir) / "manifest.json"
        if manifest_path.exists():
            try:
                existing = VectorStore.load(store_dir)
                if existing.corpus_hash == corpus_hash:
                    return existing
            except Exception:  # noqa: BLE001 — fall through to rebuild
                pass
    if encoder is None:
        encoder = SentenceEncoder(
            cfg=config.encoder, vocab_corpus=texts, device=device
        )
    if finetune_steps > 0:
        from legal_rag_tpu_torch.models.finetune import finetune_encoder

        with timer.stage("finetune"):
            encoder, losses = finetune_encoder(
                encoder,
                texts,
                steps=finetune_steps,
                log_fn=log_fn,
                chunks=chunks,
                token_maxsim_weight=finetune_token_weight,
                augment_prob=finetune_augment,
                **(
                    {"augment_kinds": tuple(
                        k.strip() for k in finetune_augment_kinds.split(",")
                        if k.strip()
                    )}
                    if finetune_augment_kinds else {}
                ),
            )
        if log_fn:
            log_fn(
                f"fine-tuned {finetune_steps} steps "
                f"(loss {losses[0]:.3f} -> {losses[-1]:.3f})"
            )

    with timer.stage("encode"):
        embeddings = encoder.encode(
            texts, batch_size=config.encoder.encode_batch
        )
    mv_tokens = mv_mask = None
    if multi_vector > 0:
        with timer.stage("tokens"):
            mv_tokens, mv_mask = _encode_token_embeddings(
                encoder, texts, multi_vector, config.encoder.encode_batch
            )
        if log_fn:
            log_fn(
                f"token-level index: [{mv_tokens.shape[0]}, "
                f"{mv_tokens.shape[1]}, {mv_tokens.shape[2]}] f16 "
                f"({mv_tokens.nbytes / 1e6:.0f} MB)"
            )
    pq_codes = pq_codebooks = pq_rotation = None
    ivf_centroids = ivf_doc_ids = None
    if pq_m > 0:
        from legal_rag_tpu_torch.ops.pq import encode_pq, train_pq

        with timer.stage("pq"):
            cb = train_pq(embeddings, m=pq_m, opq_iters=8, device=device)
            pq_codes = encode_pq(embeddings, cb, device=device)
        pq_codebooks = cb.codebooks
        pq_rotation = cb.rotation
        if log_fn:
            log_fn(f"trained OPQ+PQ codebooks (m={pq_m}, {pq_m} B/doc)")
        if ivf_cell_size > 0:
            from legal_rag_tpu_torch.ops.pq import build_ivf

            with timer.stage("ivf"):
                ivf = build_ivf(
                    embeddings, cb, pq_codes, cell_size=ivf_cell_size,
                    device=device,
                )
            ivf_centroids = ivf.centroids
            ivf_doc_ids = ivf.doc_ids
            if log_fn:
                log_fn(
                    f"built IVF coarse index ({ivf.n_cells} cells x "
                    f"{ivf_cell_size} docs)"
                )
    elif ivf_cell_size > 0:
        raise ValueError("--ivf-cell-size requires --pq-m (IVF prunes "
                         "the PQ capacity tier)")
    with timer.stage("bm25"):
        bm25 = build_bm25(
            texts,
            k1=config.bm25.k1,
            b=config.bm25.b,
            epsilon=config.bm25.epsilon,
        )
    store = VectorStore(
        embeddings=embeddings,
        bm25=bm25,
        chunks=chunks,
        wp_vocab=dict(encoder.tokenizer.vocab),
        encoder_info={
            "vocab_size": encoder.cfg.vocab_size,
            "hidden": encoder.cfg.hidden,
            "layers": encoder.cfg.layers,
            "heads": encoder.cfg.heads,
            "intermediate": encoder.cfg.intermediate,
            "max_len": encoder.cfg.max_len,
            "dtype": encoder.cfg.dtype,
            "seed": getattr(encoder, "seed", 0),
            "tokenizer_impl": encoder.tokenizer_impl,
        },
        corpus_hash=corpus_hash,
        build_params={
            "finetune_steps": finetune_steps,
            "finetune_token_weight": finetune_token_weight,
            "finetune_augment": finetune_augment,
            "finetune_augment_kinds": finetune_augment_kinds,
            "pq_m": pq_m,
            "ivf_cell_size": ivf_cell_size,
            "rerank_steps": rerank_steps,
            "rerank_sibling_prob": rerank_sibling_prob,
            "multi_vector": multi_vector,
        },
        encoder_params=encoder.params,
        pq_codes=pq_codes,
        pq_codebooks=pq_codebooks,
        pq_rotation=pq_rotation,
        mv_tokens=mv_tokens,
        mv_mask=mv_mask,
        ivf_centroids=ivf_centroids,
        ivf_doc_ids=ivf_doc_ids,
        ivf_cell_size=ivf_cell_size if ivf_centroids is not None else 0,
    )
    if rerank_steps > 0:
        with timer.stage("rerank"):
            _train_validated_reranker(
                store, encoder, texts, rerank_steps, config, log_fn,
                sibling_prob=rerank_sibling_prob, device=device,
            )
    if store_dir is not None:
        with timer.stage("save"):
            store.save(store_dir)
    return store


def _encode_token_embeddings(
    encoder: SentenceEncoder,
    texts: Sequence[str],
    token_budget: int,
    batch_size: int,
):
    """Per-chunk contextual token embeddings for the late-interaction
    tier: the L2-normalized per-token hidden states of the encoder,
    truncated to the first ``token_budget`` WordPiece tokens per chunk,
    computed on the encoder's device.

    Returns ``(tokens [N, Td, D] float16, mask [N, Td] uint8)``.
    """
    from legal_rag_tpu_torch.ops.maxsim import minilm_token_embeddings

    n = len(texts)
    d = encoder.cfg.hidden
    toks = np.zeros((n, token_budget, d), dtype=np.float16)
    mask = np.zeros((n, token_budget), dtype=np.uint8)
    max_len = min(encoder.cfg.max_len, token_budget)
    dev = encoder.device
    with torch.inference_mode():
        for lo in range(0, n, batch_size):
            batch = list(texts[lo : lo + batch_size])
            ids, am = encoder.tokenizer.encode_batch(batch, max_len=max_len)
            te = minilm_token_embeddings(
                encoder.model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(am).to(dev),
            ).float().cpu().numpy()
            t = min(te.shape[1], token_budget)
            toks[lo : lo + len(batch), :t] = te[:, :t].astype(np.float16)
            mask[lo : lo + len(batch), :t] = am[:, :t]
    return toks, mask


def _train_validated_reranker(
    store, encoder, texts, rerank_steps, config, log_fn,
    sibling_prob: float = 0.0, device="cuda",
) -> None:
    """Train the cross-encoder and persist it ONLY if it measurably
    helps on this corpus: every 7th title pair is held out of training,
    the blend weight alpha is fit on them over a grid, and the
    checkpoint is kept only when the best reranked MRR >= the base MRR
    (an undertrained CE must never ship: serving auto-enables it)."""
    from legal_rag_tpu_torch.evaluation import (
        evaluate_rerank, labeled_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.models.cross_encoder import (
        CrossEncoder, train_cross_encoder_hard,
    )
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    all_pairs = labeled_pairs_from_chunks(store.chunks)
    train_pairs = [p for i, p in enumerate(all_pairs) if i % 7]
    valid_pairs = [p for i, p in enumerate(all_pairs) if not i % 7]

    ce = CrossEncoder(encoder)
    losses = train_cross_encoder_hard(
        ce, texts, chunks=store.chunks, steps=rerank_steps, log_fn=log_fn,
        title_pairs=train_pairs, sibling_prob=sibling_prob,
    )
    if log_fn:
        log_fn(
            f"trained cross-encoder reranker {rerank_steps} steps "
            f"(hard-negative listwise, loss {losses[0]:.3f} -> "
            f"{losses[-1]:.3f})"
        )
    if not valid_pairs:
        if log_fn:
            log_fn("reranker persisted UNVALIDATED (no labeled pairs)")
        store.ce_params = ce.params
        return
    engine = RetrievalEngine(
        store, config=config, encoder=encoder, device=device
    )
    # one evaluate_rerank call scores the whole alpha grid
    grid = (0.1, 0.25, 0.5, 0.75, 1.0)
    report = evaluate_rerank(
        store, valid_pairs, ce, config=config, engine=engine,
        alphas=grid,
    )
    base = report["modes"]["base"]["mrr"]
    if log_fn:
        for alpha in grid:
            rer = report["modes"][f"reranked@{alpha}"]["mrr"]
            log_fn(f"  gate alpha={alpha}: mrr {base:.4f} -> {rer:.4f}")
    best_alpha = report["best_alpha"]
    best = report["modes"]["reranked"]["mrr"]
    if best >= base:
        store.ce_params = ce.params
        store.ce_alpha = best_alpha
        if log_fn:
            log_fn(
                f"reranker validated (held-out mrr {base:.3f} -> "
                f"{best:.3f} at alpha={best_alpha})"
            )
    elif log_fn:
        log_fn(
            f"reranker REJECTED: best reranked mrr {best:.3f} < base "
            f"{base:.3f} on {len(valid_pairs)} held-out queries — "
            f"checkpoint not persisted (train longer or from a "
            f"stronger trunk)"
        )
