"""Plain MiniLM (6-layer BERT) forward: the sentence encoder and the
cross-encoder, in float32 PyTorch with no kernel, cache or graph.

It follows all-MiniLM-L6-v2 and cross-encoder/ms-marco-MiniLM-L-6-v2 as
published: word + position + segment embeddings and a LayerNorm, then
post-LayerNorm layers (softmax attention over the real tokens, exact
erf GELU feed-forward), LayerNorm eps 1e-12. The sentence embedding is
the mean of the real tokens' last hidden states, L2-normalized. The
cross-encoder scores ``[CLS] q [SEP] d [SEP]`` with a linear head on
the same masked mean (the port's head; the published model reads the
[CLS] state through a pooler, a departure that both sides share).

Weights are the benchmark's own, in the JAX package's pytree layout
(``{"embeddings": ..., "layers": [...]}``, dense kernels ``[in, out]``),
the same arrays handed to the program. ``tf32=True`` runs every matmul
in TF32, the precision below the configuration's: the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.wordpiece import WordPieceTokenizer

EPS = 1e-12


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matmuls in TF32 (the control) or in full float32 (the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class PlainMiniLM:
    """The trunk's weights on ``device`` and its forward."""

    def __init__(self, params: Dict, heads: int, device):
        self.heads = heads
        emb = params["embeddings"]
        self.word = _t(emb["word"], device)
        self.position = _t(emb["position"], device)
        self.token_type = _t(emb["token_type"], device)
        self.emb_ln = (_t(emb["ln"]["scale"], device),
                       _t(emb["ln"]["bias"], device))
        self.layers = []
        for lp in params["layers"]:
            att = lp["attention"]
            self.layers.append({
                name: (_t(att[name]["kernel"], device),
                       _t(att[name]["bias"], device))
                for name in ("query", "key", "value", "output")
            } | {
                "attention_ln": (_t(lp["attention_ln"]["scale"], device),
                                 _t(lp["attention_ln"]["bias"], device)),
                "intermediate": (_t(lp["intermediate"]["kernel"], device),
                                 _t(lp["intermediate"]["bias"], device)),
                "output_dense": (_t(lp["output"]["kernel"], device),
                                 _t(lp["output"]["bias"], device)),
                "output_ln": (_t(lp["output_ln"]["scale"], device),
                              _t(lp["output_ln"]["bias"], device)),
            })

    @staticmethod
    def _ln(x, scale_bias):
        scale, bias = scale_bias
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + EPS) * scale + bias

    @staticmethod
    def _dense(x, kernel_bias):
        kernel, bias = kernel_bias
        return x @ kernel + bias

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor,
               token_types: torch.Tensor) -> torch.Tensor:
        """Last hidden states ``[B, L, H]``; ``mask`` 1 on real tokens."""
        b, l = ids.shape
        x = (self.word[ids] + self.position[:l][None]
             + self.token_type[token_types])
        x = self._ln(x, self.emb_ln)
        h = x.shape[-1]
        dh = h // self.heads
        real = mask.bool()[:, None, None, :]
        for lp in self.layers:
            def split(t):
                return t.view(b, l, self.heads, dh).transpose(1, 2)
            q = split(self._dense(x, lp["query"]))
            k = split(self._dense(x, lp["key"]))
            v = split(self._dense(x, lp["value"]))
            scores = q @ k.transpose(-1, -2) / math.sqrt(dh)
            scores = scores.masked_fill(~real, float("-inf"))
            ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2)
            att = self._dense(ctx.reshape(b, l, h), lp["output"])
            x = self._ln(x + att, lp["attention_ln"])
            inter = self._dense(x, lp["intermediate"])
            inter = 0.5 * inter * (1.0 + torch.erf(inter / math.sqrt(2.0)))
            x = self._ln(x + self._dense(inter, lp["output_dense"]),
                         lp["output_ln"])
        return x

    @staticmethod
    def masked_mean(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.to(hidden.dtype)[:, :, None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1)


def _pad(rows: Sequence[Sequence[int]], pad_id: int, device):
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), pad_id, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return (torch.as_tensor(ids, device=device),
            torch.as_tensor(mask, device=device))


class PlainEncoder:
    """Texts to unit sentence embeddings ``[B, H]`` float32 (numpy)."""

    def __init__(self, params: Dict, vocab: Dict[str, int], heads: int,
                 max_len: int, device, block: int = 64):
        self.trunk = PlainMiniLM(params, heads, device)
        self.tok = WordPieceTokenizer(vocab)
        self.max_len = max_len
        self.device = device
        self.block = block

    def token_ids(self, text: str) -> List[int]:
        return self.tok.encode(text, max_len=self.max_len)

    def encode(self, texts: Sequence[str], tf32: bool = False) -> np.ndarray:
        out = []
        with torch.no_grad(), matmul_precision(tf32):
            for lo in range(0, len(texts), self.block):
                rows = [self.token_ids(t) for t in texts[lo:lo + self.block]]
                ids, mask = _pad(rows, self.tok.pad_id, self.device)
                h = self.trunk.hidden(ids, mask, torch.zeros_like(ids))
                pooled = PlainMiniLM.masked_mean(h, mask)
                pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp(
                    min=1e-12)
                out.append(pooled.cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


class PlainCrossEncoder:
    """(query, doc) pairs to relevance logits ``[B]`` float32 (numpy)."""

    def __init__(self, params: Dict, vocab: Dict[str, int], heads: int,
                 max_len: int, device):
        self.trunk = PlainMiniLM(params["trunk"], heads, device)
        self.head_w = _t(params["head"]["w"], device)
        self.head_b = _t(params["head"]["b"], device)
        self.tok = WordPieceTokenizer(vocab)
        self.max_len = min(max_len, 256)
        self.device = device

    def pair_ids(self, query: str, doc: str) -> Tuple[List[int], List[int]]:
        """``[CLS] q [SEP] d [SEP]`` and its segment ids: the query keeps
        at most half the budget, the document the rest."""
        tok, max_len = self.tok, self.max_len
        q_ids = tok.encode(query, max_len=max_len, add_special=False)
        q_ids = q_ids[:max_len // 2 - 2]
        d_cap = max_len - len(q_ids) - 3
        d_ids = tok.encode(doc, max_len=max_len, add_special=False)[:d_cap]
        ids = [tok.cls_id] + q_ids + [tok.sep_id] + d_ids + [tok.sep_id]
        types = [0] * (len(q_ids) + 2) + [1] * (len(d_ids) + 1)
        return ids, types

    def scores(self, queries: Sequence[str], docs: Sequence[str],
               tf32: bool = False) -> np.ndarray:
        pairs = [self.pair_ids(q, d) for q, d in zip(queries, docs)]
        ids, mask = _pad([p[0] for p in pairs], self.tok.pad_id, self.device)
        types, _ = _pad([p[1] for p in pairs], 0, self.device)
        with torch.no_grad(), matmul_precision(tf32):
            h = self.trunk.hidden(ids, mask, types)
            pooled = PlainMiniLM.masked_mean(h, mask)
            return (pooled @ self.head_w + self.head_b).cpu().numpy()
