"""SentenceEncoder: WordPiece tokenizer + MiniLM forward, batched.

Mirrors ``legal_rag_tpu.models.encoder.SentenceEncoder``: texts are
tokenized once, encoded in length-sorted ``encode_batch`` chunks padded
to power-of-two buckets (``pad_and_bucket``), and returned in input
order as L2-normalized ``[B, H]`` float32 rows.

The port tokenizes in Python; the JAX package's C++ tokenizer binding
is not ported yet (the two agree on ASCII text).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.config import EncoderConfig
from legal_rag_tpu_torch.models.convert import (
    MiniLMParams, minilm_state_dict_from_jax,
)
from legal_rag_tpu_torch.models.minilm import MiniLM, minilm_encode
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, pad_and_bucket,
)


class SentenceEncoder:
    """Batched text -> normalized ``[B, H]`` embeddings on ``device``.

    ``params`` (the JAX param pytree, e.g. a store's ``encoder.npz``)
    are required: the JAX package's random init draws from
    ``jax.random``, which the port cannot reproduce.
    """

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[MiniLMParams] = None,
        tokenizer: Optional[WordPieceTokenizer] = None,
        device="cuda",
    ):
        if params is None:
            raise ValueError(
                "SentenceEncoder needs encoder weights: the store has no "
                "encoder.npz (build it with the JAX package's build_index, "
                "which always writes one)"
            )
        if tokenizer is None:
            raise ValueError("SentenceEncoder needs a WordPiece tokenizer")
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.params = params
        self.model = MiniLM.from_state_dict(
            cfg or EncoderConfig(), minilm_state_dict_from_jax(params)
        ).to(self.device)
        self.cfg = self.model.cfg

    def encode(
        self,
        texts: Sequence[str],
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Encode texts in device batches; returns ``[B, H]`` float32."""
        batch_size = batch_size or self.cfg.encode_batch
        if not texts:
            return np.zeros((0, self.cfg.hidden), dtype=np.float32)
        tok = self.tokenizer
        encoded = [
            np.asarray(tok.encode(t, max_len=self.cfg.max_len), np.int32)
            for t in texts
        ]
        order = sorted(range(len(texts)), key=lambda i: len(encoded[i]))
        out = np.empty((len(texts), self.cfg.hidden), dtype=np.float32)
        with torch.inference_mode():
            for lo in range(0, len(order), batch_size):
                idx = order[lo:lo + batch_size]
                ids, mask = pad_and_bucket(
                    [encoded[i] for i in idx], self.cfg.max_len, tok.pad_id,
                )
                emb = minilm_encode(
                    self.model,
                    torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(mask).to(self.device),
                )
                out[idx] = emb.cpu().numpy()
        return out
