"""A synthetic store at a realistic size, made from a seed with numpy.

:func:`synthesize_store` builds a :class:`VectorStore` in the format
``legal_rag_tpu`` writes, shaped like the serving corpus
(2,620 legal chunks, mean chunk length 104 BM25 tokens) but at any doc
count: BM25 token streams with Zipf term frequencies over a 50k-term
vocabulary, the Okapi CSR computed vectorised with the same formula and
term order as ``build_bm25``, a WordPiece vocab from a sample of the
texts, MiniLM weights at full width (seeded N(0, 0.02)), a
cross-encoder checkpoint, random unit embeddings, and the PQ and IVF
artifacts of the capacity tier (``pq.npz``, ``ivf.npz``), trained by the
port as ``build --pq-m 48 --ivf-cell-size 1024`` would train them (for
embedding widths that divide by the 96 nibble subspaces, as MiniLM's
384 does).

For each query in ``planted`` one doc is planted: its embedding is the
encoder's embedding of that query and its text repeats the query's
words, so hybrid search must rank it first on both channels.

With ``multi_vector=Td`` the store also carries the late-interaction
slab of ``build --multi-vector Td`` (``mv_tokens.npy`` float16,
``mv_mask.npy`` uint8): a doc's tokens are its unit embedding plus
0.25 N(0, 1) noise, normalized, as many as its BM25 length up to Td (the
data of ``scripts/bench_maxsim_scale.py``); a planted doc's tokens are
the encoder's token states of its query, so both MaxSim modes rank it
first.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from legal_rag_tpu_torch.config import EncoderConfig
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.minilm import random_minilm_params
from legal_rag_tpu_torch.models.wordpiece import build_wordpiece_vocab
from legal_rag_tpu_torch.ops.sparse import BM25Index, tokenize

MEAN_LEN = 104.0     # BM25 tokens per chunk in the serving corpus
# the cross-encoder's blend weight: the smallest of the JAX build gate's
# grid, so random CE weights refine the retrieval order but cannot
# overturn it (a random CE carries no relevance signal)
CE_ALPHA = 0.1
PQ_M = 48            # the capacity tier's bytes a doc (`build --pq-m 48`)
IVF_CELL_SIZE = 1024  # docs per IVF cell (`build --ivf-cell-size 1024`)

_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"
_SYLLABLES = [c + v for c in _CONSONANTS for v in _VOWELS]      # 90


def _synthetic_words(count: int, taken: set) -> List[str]:
    """Pronounceable lowercase words of 2-3 syllables, none in ``taken``."""
    out: List[str] = []
    n_syl = len(_SYLLABLES)
    i = 0
    while len(out) < count:
        if i < n_syl ** 2:
            w = _SYLLABLES[i // n_syl] + _SYLLABLES[i % n_syl]
        else:
            j = i - n_syl ** 2
            w = (_SYLLABLES[j // n_syl ** 2] + _SYLLABLES[(j // n_syl) % n_syl]
                 + _SYLLABLES[j % n_syl])
        if w not in taken:
            out.append(w)
        i += 1
    return out


def _vocabulary(queries: Sequence[str], size: int):
    """(words, probabilities): query words at mid ranks (so their IDF
    is informative), except frequent function words at the head;
    synthetic words fill the other ranks. Zipf over rank, exponent 1."""
    head = ["the", "of", "and", "to", "a", "in", "is", "for", "or", "be",
            "by", "any", "shall", "such", "with", "as", "on", "which",
            "who", "that", "under", "may", "it", "from", "at", "this",
            "was", "are", "what", "i", "my", "me", "how", "can", "just"]
    seen = set(head)
    query_words = []
    for q in queries:
        for w in tokenize(q):
            if w not in seen:
                seen.add(w)
                query_words.append(w)
    n_fill = size - len(head) - len(query_words)
    fill = _synthetic_words(n_fill, seen)
    # query words sit at ranks 1000, 1400, 1800, ...: frequent enough to
    # appear in many docs at 1M, rare enough to carry weight
    words = head + fill
    for j, w in enumerate(query_words):
        words.insert(min(1000 + 400 * j, len(words)), w)
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    p = 1.0 / (ranks + 2.7)
    return words, p / p.sum()


def _sample_tokens(rng, p: np.ndarray, total: int) -> np.ndarray:
    """``total`` term indices drawn from ``p`` (int32, chunked)."""
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    out = np.empty(total, dtype=np.int32)
    step = 1 << 23
    for lo in range(0, total, step):
        hi = min(total, lo + step)
        out[lo:hi] = np.searchsorted(cdf, rng.random(hi - lo), side="right")
    return out


def bm25_csr(
    tokens: np.ndarray,       # [T] term index per token, docs concatenated
    lengths: np.ndarray,      # [N] tokens per doc
    words: Sequence[str],     # term index -> token text
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
) -> BM25Index:
    """The :func:`build_bm25` index of the given token streams, computed
    vectorised: same vocab order (first occurrence), same postings order
    (term, then ascending doc), same Okapi weights in the same dtypes."""
    n_docs = len(lengths)
    doc_len = lengths.astype(np.int32)
    avgdl = float(doc_len.sum()) / max(n_docs, 1)
    # vocab ids in order of first occurrence over the corpus scan
    present, first = np.unique(tokens, return_index=True)
    present = present[np.argsort(first, kind="stable")]
    term_id = np.full(len(words), -1, dtype=np.int64)
    term_id[present] = np.arange(len(present))
    vocab = {words[t]: i for i, t in enumerate(present.tolist())}
    v = len(present)

    doc = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    key = term_id[tokens] * n_docs + doc
    pairs, tf = np.unique(key, return_counts=True)   # sorted: term, doc
    p_term = pairs // n_docs
    p_doc = (pairs % n_docs).astype(np.int32)
    df = np.bincount(p_term, minlength=v).astype(np.int64)
    raw_idf = np.log(n_docs - df + 0.5) - np.log(df + 0.5)
    avg_idf = float(raw_idf.mean()) if v else 0.0
    idf = np.where(raw_idf < 0, epsilon * avg_idf, raw_idf).astype(np.float32)
    indptr = np.zeros(v + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(df)
    norm_denom = k1 * (1.0 - b + b * doc_len / max(avgdl, 1e-9))
    # build_bm25's scalar arithmetic: float32 numerator, float64
    # denominator, float64 quotient stored as float32
    num = idf[p_term] * tf.astype(np.float32) * np.float32(k1 + 1.0)
    weights = (num.astype(np.float64) / (tf + norm_denom[p_doc])).astype(
        np.float32
    )
    return BM25Index(
        vocab=vocab, indptr=indptr, doc_ids=p_doc, weights=weights,
        idf=idf, doc_len=doc_len, n_docs=n_docs, avgdl=avgdl,
        k1=k1, b=b, epsilon=epsilon,
    )


def synthesize_store(
    n_docs: int,
    seed: int = 0,
    planted: Sequence[str] = (),
    vocab_queries: Sequence[str] = (),
    cfg: Optional[EncoderConfig] = None,
    vocab_size: int = 50_000,
    device="cuda",
    multi_vector: int = 0,
    mv_dir=None,
) -> VectorStore:
    """A store of ``n_docs`` synthetic chunks (see module doc).

    ``planted``: queries that each get one planted doc, at ids
    ``planted_ids(n_docs, len(planted))``. ``vocab_queries``: further
    queries whose words must be in the BM25 vocabulary. ``device``
    runs the port's encoder for the planted embeddings and the PQ/IVF
    training, and draws the token slab. ``multi_vector``: the slab's
    token budget Td (0: no slab); the slab is written in row chunks
    into ``mv_dir`` and returned memory-mapped from there.
    """
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer
    from legal_rag_tpu_torch.ops.pq import build_ivf, encode_pq, train_pq

    cfg = cfg or EncoderConfig()
    rng = np.random.default_rng(seed)
    words, p = _vocabulary(list(planted) + list(vocab_queries), vocab_size)
    index_of = {w: i for i, w in enumerate(words)}

    sigma = 0.5
    lengths = np.clip(
        rng.lognormal(np.log(MEAN_LEN) - sigma ** 2 / 2, sigma, n_docs),
        8, 400,
    ).astype(np.int64)
    tokens = _sample_tokens(rng, p, int(lengths.sum()))
    plant_at = planted_ids(n_docs, len(planted))
    if len(planted):
        # planted docs: the query's words three times over, then filler
        pieces, starts = [], np.concatenate([[0], np.cumsum(lengths)])
        prev = 0
        for doc_id, q in zip(plant_at, planted):
            own = np.array([index_of[w] for w in tokenize(q)] * 3, np.int32)
            pieces.append(tokens[starts[prev]:starts[doc_id]])
            pieces.append(own)
            lengths[doc_id] = len(own)
            prev = doc_id + 1
        pieces.append(tokens[starts[prev]:])
        tokens = np.concatenate(pieces)

    bm25 = bm25_csr(tokens, lengths, words)
    words_arr = np.asarray(words, dtype=object)
    ends = np.cumsum(lengths)
    chunks = []
    for i, (lo, hi) in enumerate(zip(ends - lengths, ends)):
        text = " ".join(words_arr[tokens[lo:hi]].tolist())
        header = f"SYN {i:07d}"
        chunks.append({
            "text": text,
            "canonical_header": header,
            "section_id": f"SYN_{i:07d}",
            "metadata": {"law": "SYN", "section": str(i),
                         "unit_type": "section"},
        })
    for j, doc_id in enumerate(plant_at):
        chunks[doc_id]["canonical_header"] = f"PLANTED {j}"

    sample = [c["text"] for c in chunks[:: max(1, n_docs // 2_000)]]
    wp_vocab = build_wordpiece_vocab(
        sample + list(planted) + list(vocab_queries), size=cfg.vocab_size
    )
    enc_params = random_minilm_params(rng, cfg, len(wp_vocab))
    ce_params = {
        "trunk": random_minilm_params(rng, cfg, len(wp_vocab)),
        "head": {"w": (0.02 * rng.standard_normal(cfg.hidden)).astype(np.float32),
                 "b": np.zeros((), np.float32)},
    }

    emb = rng.standard_normal((n_docs, cfg.hidden), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    encoder = None
    if len(planted):
        encoder = SentenceEncoder(
            cfg=cfg, params=enc_params,
            tokenizer=WordPieceTokenizer(wp_vocab), device=device,
        )
        emb[plant_at] = encoder.encode(list(planted))
    mv = {}
    if multi_vector:
        if mv_dir is None:
            raise ValueError("multi_vector needs mv_dir, the directory "
                             "the token slab is written to")
        mv = _token_slab(emb, lengths, multi_vector, mv_dir, seed, device,
                        plant_at, planted, encoder)

    # the capacity tier's artifacts, as `build --pq-m --ivf-cell-size`
    # makes them (OPQ on, 8 rounds)
    pq = {}
    if cfg.hidden % (2 * PQ_M) == 0:
        cb = train_pq(emb, m=PQ_M, opq_iters=8, device=device)
        pq = {"pq_codes": encode_pq(emb, cb, device=device),
              "pq_codebooks": cb.codebooks, "pq_rotation": cb.rotation}
        ivf = build_ivf(emb, cb, pq["pq_codes"], cell_size=IVF_CELL_SIZE,
                        device=device)
        pq.update(ivf_centroids=ivf.centroids, ivf_doc_ids=ivf.doc_ids,
                  ivf_cell_size=IVF_CELL_SIZE)

    return VectorStore(
        embeddings=emb,
        bm25=bm25,
        chunks=chunks,
        wp_vocab=wp_vocab,
        encoder_info={
            **{f.name: getattr(cfg, f.name)
               for f in dataclasses.fields(cfg)
               if f.name in ("hidden", "layers", "heads", "intermediate",
                             "max_len", "dtype")},
            "vocab_size": len(wp_vocab),
            "seed": seed,
            "tokenizer_impl": "python",
        },
        encoder_params=enc_params,
        ce_params=ce_params,
        ce_alpha=CE_ALPHA,
        build_params={"synthetic": {"n_docs": n_docs, "seed": seed},
                      **({"pq_m": PQ_M, "ivf_cell_size": IVF_CELL_SIZE}
                         if pq else {}),
                      **({"multi_vector": multi_vector} if mv else {})},
        **pq,
        **mv,
    )


def _token_slab(emb, lengths, td: int, mv_dir, seed: int, device,
               plant_at=(), planted=(), encoder=None) -> Dict:
    """The late-interaction slab of the module doc, drawn on ``device``
    from a seeded generator and written through
    ``np.lib.format.open_memmap`` into ``mv_dir`` in chunks of 16,384
    docs; returns ``{"mv_tokens", "mv_mask"}`` memory-mapped."""
    import torch

    from legal_rag_tpu_torch.ops.maxsim import minilm_token_embeddings

    n, d = emb.shape
    os.makedirs(mv_dir, exist_ok=True)
    tok_path = os.path.join(mv_dir, "mv_tokens.npy")
    mask_path = os.path.join(mv_dir, "mv_mask.npy")
    counts = np.minimum(lengths, td)
    plant_tok = []
    if len(planted):
        ids, am = encoder.tokenizer.encode_batch(
            list(planted), max_len=min(encoder.cfg.max_len, td))
        with torch.inference_mode():
            states = minilm_token_embeddings(
                encoder.model, torch.from_numpy(ids).to(encoder.device),
                torch.from_numpy(am).to(encoder.device),
            ).cpu().numpy()
        for doc, row, m in zip(plant_at, states, am):
            counts[doc] = int(m.sum())
            plant_tok.append((doc, row[m > 0]))
    mask = (np.arange(td)[None, :] < counts[:, None]).astype(np.uint8)
    np.save(mask_path, mask)

    toks = np.lib.format.open_memmap(tok_path, mode="w+", dtype=np.float16,
                                     shape=(n, td, d))
    g = torch.Generator(device=device).manual_seed(seed)
    step = 16384
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        e = torch.from_numpy(emb[lo:hi]).to(device)
        t = e[:, None, :] + 0.25 * torch.randn(
            (hi - lo, td, d), generator=g, device=device)
        t /= t.norm(dim=2, keepdim=True)
        t *= torch.from_numpy(mask[lo:hi]).to(device)[:, :, None]
        toks[lo:hi] = t.half().cpu().numpy()
    for doc, rows in plant_tok:
        toks[doc] = 0
        toks[doc, : len(rows)] = rows
    toks.flush()
    del toks
    return {"mv_tokens": np.load(tok_path, mmap_mode="r"),
            "mv_mask": np.load(mask_path, mmap_mode="r")}


def planted_ids(n_docs: int, n_planted: int) -> List[int]:
    """Doc ids of the planted docs: spread over the corpus, so they fall
    in different K1 segments and (at 1M docs) far into the index."""
    return [int((j + 1) * n_docs // (n_planted + 1)) + 3
            for j in range(n_planted)]
