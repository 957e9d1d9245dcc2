"""Multi-vector late-interaction retrieval (ColBERT-style MaxSim).

The PyTorch counterpart of ``legal_rag_tpu.ops.maxsim``: a query scores
a document as the sum over query tokens of the best-matching document
token similarity::

    MaxSim(q, d) = sum_i  max_j  <q_i, d_j>

Index layout: ``doc_tokens [N, Td, D]`` (a fixed token budget a doc,
zero-padded) and ``doc_mask [N, Td]``. Padding tokens are -inf inside
the max (a zero vector's similarity of 0 could beat real negative
ones), a doc with no tokens scores 0, padded query tokens add nothing.

The JAX package computes MaxSim with XLA ops and no Pallas kernel, so
this module has no hand kernel either: the token products are torch
matmuls that sum in fp32 (bf16 operands multiply exactly, as the JAX
package's ``preferred_element_type=float32``), and the masked max and
sum are torch reductions. :func:`maxsim_topk` blocks over documents,
so the ``[Q*Tq, B*Td]`` similarities exist for one block at a time;
:func:`maxsim_rescore` late-interacts only given candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.models.minilm import (
    MiniLM, mean_pool, minilm_hidden_states,
)
from legal_rag_tpu_torch.ops.dense import (
    l2_normalize, lax_top_k, sort_score_desc_id_asc,
)

_NEG_INF = float("-inf")
# a full-scan block's fp32 similarities, [Q*Tq, B*Td], stay within this
SIMS_BLOCK_BYTES = 1 << 28


def token_sims(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., M, D] x b [..., N, D] -> [..., M, N]`` fp32 inner
    products (2-D or batched 3-D). Two bf16 operands multiply exactly
    and sum in fp32: on the card by ``torch.mm(out_dtype=float32)``,
    elsewhere by widening (a product of two bf16 values is exact in
    fp32). fp32 operands stay fp32; callers keep TF32 off."""
    bt = b.transpose(-1, -2)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, bt, out_dtype=torch.float32)
    return a.float() @ bt.float()


def _maxsim_reduce(sims: torch.Tensor, doc_pad: torch.Tensor,
                   q_mask: torch.Tensor) -> torch.Tensor:
    """``sims [Q, Tq, B, Td]`` (overwritten) -> ``[Q, B]`` MaxSim.
    ``doc_pad`` broadcasts to ``sims`` (True = padding doc token);
    ``q_mask [Q, Tq]`` (> 0 = real query token)."""
    sims.masked_fill_(doc_pad, _NEG_INF)
    best = sims.amax(dim=3)                          # [Q, Tq, B]
    best = torch.where(torch.isfinite(best), best, 0.0)
    best = best * (q_mask > 0)[:, :, None]
    return best.sum(dim=1)


def maxsim_topk(
    q_tokens: torch.Tensor,    # [Q, Tq, D] query token embeddings
    q_mask: torch.Tensor,      # [Q, Tq] 1 = real token
    doc_tokens: torch.Tensor,  # [N, Td, D]
    doc_mask: torch.Tensor,    # [N, Td]
    k: int,
    block_n: int = 512,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim top-k: ``(scores [Q, k] fp32, ids [Q, k] int32)``,
    scores descending, ties to the lowest doc id.

    ``n_valid``: the count of real docs; rows at or past it never
    compete, though their all-padding score of 0 could beat real
    negative scores. Results do not depend on ``block_n``.
    """
    q, tq, d = q_tokens.shape
    n, td, _ = doc_tokens.shape
    nb = -(-n // block_n)
    qt = q_tokens.reshape(q * tq, d)
    scores = torch.full((q, nb * block_n), _NEG_INF, dtype=torch.float32,
                        device=doc_tokens.device)
    for lo in range(0, n, block_n):
        bt = doc_tokens[lo:lo + block_n]
        b = bt.shape[0]
        sims = token_sims(qt, bt.reshape(b * td, d)).view(q, tq, b, td)
        pad = (doc_mask[lo:lo + b] <= 0)[None, None]
        scores[:, lo:lo + b] = _maxsim_reduce(sims, pad, q_mask)
    limit = n if n_valid is None else min(n, int(n_valid))
    scores[:, max(limit, 0):] = _NEG_INF
    top_s, top_i = lax_top_k(scores, k)
    return top_s, top_i.int()


def scan_block_n(q: int, tq: int, td: int) -> int:
    """Docs a :func:`maxsim_topk` block for a ``[Q, Tq]`` batch over a
    ``Td`` slab: the largest power of two from 512 (the JAX default)
    whose fp32 similarities fit ``SIMS_BLOCK_BYTES``. Each block costs
    a handful of launches from Python, so fewer blocks keep a small
    batch's scan off the host's clock; the results do not depend on
    it."""
    b = 512
    while 2 * b * q * tq * td * 4 <= SIMS_BLOCK_BYTES:
        b *= 2
    return b


def maxsim_rescore(
    q_tokens: torch.Tensor,    # [Q, Tq, D]
    q_mask: torch.Tensor,      # [Q, Tq]
    doc_tokens: torch.Tensor,  # [N, Td, D] token slab
    doc_mask: torch.Tensor,    # [N, Td]
    cand_ids: torch.Tensor,    # [Q, C] doc ids (may hold invalid slots:
                               #        < 0 or >= n_valid)
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxSim over a bounded candidate set, the capacity-safe tier:
    one contiguous ``Td*D`` row a candidate (``[N, Td*D]`` is a view of
    the slab), so a batch reads ``O(C * Td * D)`` of it, not all of it.

    Returns ``(scores [Q, k], ids [Q, k] int32)`` by (score desc, id
    asc); invalid candidates sink last as ``(-inf, -1)``, and a ``C``
    below ``k`` pads with them.
    """
    q, tq, d = q_tokens.shape
    n, td, _ = doc_tokens.shape
    c = cand_ids.shape[1]
    limit = n if n_valid is None else int(n_valid)
    cand = cand_ids.long()
    valid = (cand >= 0) & (cand < limit)
    safe = cand.clamp(0, n - 1)

    g = doc_tokens.reshape(n, td * d)[safe]          # [Q, C, Td*D]
    gm = doc_mask[safe]                              # [Q, C, Td]
    sims = token_sims(q_tokens, g.view(q, c * td, d)).view(q, tq, c, td)
    scores = _maxsim_reduce(sims, (gm <= 0)[:, None], q_mask)
    scores = torch.where(valid, scores, _NEG_INF)

    # (score desc, id asc); invalid slots sink last with unique keys
    slot = torch.arange(c, device=cand.device)
    sort_ids = torch.where(valid, safe, n + slot)
    kk = min(k, c)
    out_s, ids_sorted = sort_score_desc_id_asc(scores, sort_ids)
    out_s, out_i = out_s[:, :kk], ids_sorted[:, :kk]
    out_i = torch.where(out_i >= n, -1, out_i)
    if kk < k:
        out_s = torch.cat([out_s, out_s.new_full((q, k - kk), _NEG_INF)], 1)
        out_i = torch.cat([out_i, out_i.new_full((q, k - kk), -1)], 1)
    return out_s, out_i.int()


@dataclasses.dataclass
class MultiVectorIndex:
    """Token-level index for late-interaction search."""

    doc_tokens: torch.Tensor   # [N, Td, D], L2-normalized real tokens
    doc_mask: torch.Tensor     # [N, Td] int32
    n_docs: int

    @classmethod
    def from_token_embeddings(
        cls,
        token_embeddings,    # list of [t_i, D] arrays (variable length)
        token_budget: int = 32,
        dtype: str = "float32",
        device="cuda",
    ) -> "MultiVectorIndex":
        """Pack per-doc token embeddings into the fixed ``[N, Td, D]``
        layout (the first ``token_budget`` tokens kept, L2-normalized)."""
        n = len(token_embeddings)
        if n == 0:
            raise ValueError("no documents")
        dim = token_embeddings[0].shape[-1]
        toks = np.zeros((n, token_budget, dim), dtype=np.float32)
        mask = np.zeros((n, token_budget), dtype=np.int32)
        for i, te in enumerate(token_embeddings):
            te = np.asarray(te, dtype=np.float32)[:token_budget]
            norms = np.linalg.norm(te, axis=-1, keepdims=True)
            te = te / np.maximum(norms, 1e-12)
            toks[i, : te.shape[0]] = te
            mask[i, : te.shape[0]] = 1
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        return cls(
            doc_tokens=torch.from_numpy(toks).to(device).to(target),
            doc_mask=torch.from_numpy(mask).to(device), n_docs=n,
        )

    def search(
        self, q_tokens, q_mask, k: int, block_n: int = 512
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.doc_tokens.device
        return maxsim_topk(
            torch.as_tensor(q_tokens).to(dev, self.doc_tokens.dtype),
            torch.as_tensor(q_mask).to(dev),
            self.doc_tokens, self.doc_mask, k, block_n=block_n,
        )


def minilm_token_embeddings(model: MiniLM, input_ids, attention_mask):
    """Per-token contextual embeddings from the MiniLM encoder
    (L2-normalized), the encoder side of late interaction."""
    return l2_normalize(minilm_hidden_states(model, input_ids, attention_mask))


def minilm_token_and_pooled(model: MiniLM, input_ids, attention_mask):
    """One transformer forward, two views: the L2-normalized per-token
    states and the L2-normalized masked-mean sentence embedding, which
    serving's maxsim-rerank needs together for one query batch."""
    hidden = minilm_hidden_states(model, input_ids, attention_mask)
    return l2_normalize(hidden), mean_pool(hidden, attention_mask)


class MultiVectorSearcher:
    """Text-in, results-out late-interaction search over an encoder
    (:class:`legal_rag_tpu_torch.models.encoder.SentenceEncoder`): the
    corpus runs through MiniLM in batches into the token-level index on
    the encoder's device; queries encode the same way at search time."""

    def __init__(
        self,
        texts: Sequence[str],
        encoder,
        token_budget: int = 32,
        dtype: str = "float32",
        batch_size: int = 64,
        block_n: int = 512,
    ):
        self.encoder = encoder
        self.token_budget = token_budget
        self.block_n = block_n
        token_embeddings = []
        for lo in range(0, len(texts), batch_size):
            ids, mask = self._tokenize(texts[lo:lo + batch_size])
            tok = self._tokens(ids, mask).cpu().numpy()
            for row_tok, row_mask in zip(tok, mask):
                token_embeddings.append(row_tok[row_mask > 0])
        self.index = MultiVectorIndex.from_token_embeddings(
            token_embeddings, token_budget=token_budget, dtype=dtype,
            device=encoder.device,
        )

    def _tokenize(self, texts):
        return self.encoder.fast_tokenizer.encode_batch(
            list(texts), max_len=min(self.encoder.cfg.max_len, 128)
        )

    def _tokens(self, ids, mask) -> torch.Tensor:
        dev = self.encoder.device
        with torch.inference_mode():
            return minilm_token_embeddings(
                self.encoder.model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(mask).to(dev),
            )

    def search(self, queries: Sequence[str], k: int = 5):
        """Returns ``(scores [Q, k], ids [Q, k])`` numpy arrays."""
        ids, mask = self._tokenize(queries)
        q_tok = self._tokens(ids, mask)
        # trim the query tokens to the index budget
        tq = min(q_tok.shape[1], self.token_budget)
        s, i = self.index.search(
            q_tok[:, :tq], mask[:, :tq], k, block_n=self.block_n
        )
        return s.cpu().numpy(), i.cpu().numpy()
