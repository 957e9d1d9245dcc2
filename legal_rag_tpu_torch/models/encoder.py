"""SentenceEncoder: WordPiece tokenizer + MiniLM forward, batched.

Mirrors ``legal_rag_tpu.models.encoder.SentenceEncoder``: texts are
tokenized once, encoded in length-sorted ``encode_batch`` chunks padded
to power-of-two buckets (``pad_and_bucket``), and returned in input
order as L2-normalized ``[B, H]`` float32 rows.

Weights come from the JAX param pytree (a store's ``encoder.npz``, a
converted checkpoint, a fine-tune) or, without one, from the port's
numpy init (:func:`legal_rag_tpu_torch.models.minilm.init_minilm_params`)
over a vocab built from ``vocab_corpus``, as the JAX package's random
init is. The two inits draw different numbers from one seed (the
builder fingerprints a build without given weights apart).

Tokenizers: the C++ WordPiece (``native_ext.NativeWordPiece``, built
on first use) where it builds and ``prefer_tokenizer`` allows it, else
the Python one, as the JAX constructor chooses; ``tokenizer_impl``
names the one ``tokenize`` and ``encode`` use. The two agree on every
tested input (``tests/test_torch_native.py``) but may differ on exotic
non-Latin text, so a store records its choice and the engine pins it.

``graphs``: a :class:`~legal_rag_tpu_torch.utils.graphs.GraphSet` (the
serving engine attaches its own) replays one captured forward per
``(batch, length)`` bucket, the shapes the JAX encoder compiles for;
None (the default, and the build path's) runs the forward op by op.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from legal_rag_tpu_torch.config import EncoderConfig
from legal_rag_tpu_torch.models.convert import (
    MiniLMParams, minilm_state_dict_from_jax,
)
from legal_rag_tpu_torch.models.minilm import (
    MiniLM, init_minilm_params, minilm_encode,
)
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab, pad_and_bucket,
)
from legal_rag_tpu_torch.utils.graphs import GraphSet, run_program


class SentenceEncoder:
    """Batched text -> normalized ``[B, H]`` embeddings on ``device``.

    Weight sources, in order of preference: ``params`` (the JAX param
    pytree), else the numpy init from ``seed`` with the word table sized
    to the tokenizer. The tokenizer is ``tokenizer``, else a vocab built
    from ``vocab_corpus``; ``prefer_tokenizer`` (the JAX constructor's
    values) picks its implementation: ``"auto"`` and ``"native-cpp"`` the
    C++ one where it builds (``"native-cpp"`` warns where it does not),
    ``"python"`` never.
    """

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[MiniLMParams] = None,
        tokenizer: Optional[WordPieceTokenizer] = None,
        vocab_corpus: Optional[Sequence[str]] = None,
        seed: int = 0,
        prefer_tokenizer: str = "auto",
        device="cuda",
    ):
        if prefer_tokenizer not in ("auto", "python", "native-cpp"):
            raise ValueError(f"unknown prefer_tokenizer {prefer_tokenizer!r}")
        cfg = cfg or EncoderConfig()
        self.seed = seed
        if tokenizer is None:
            corpus = list(vocab_corpus) if vocab_corpus else ["placeholder"]
            tokenizer = WordPieceTokenizer(
                build_wordpiece_vocab(corpus, size=cfg.vocab_size)
            )
        self.tokenizer = tokenizer
        self._fast_tokenizer = None
        if prefer_tokenizer != "python":
            try:
                from legal_rag_tpu_torch import native_ext

                if native_ext.native_available():
                    self._fast_tokenizer = native_ext.NativeWordPiece(
                        tokenizer.vocab
                    )
            except Exception:  # noqa: BLE001 — an accelerator only
                self._fast_tokenizer = None
            if prefer_tokenizer == "native-cpp" and self._fast_tokenizer is None:
                logging.getLogger("legal_rag_tpu_torch.encoder").warning(
                    "store was built with the native-cpp tokenizer but it "
                    "is unavailable here; falling back to pure Python "
                    "(tokenizations may differ on non-Latin input)"
                )
        if params is None:
            # size the word table to the tokenizer so ids index in range
            cfg = dataclasses.replace(
                cfg, vocab_size=max(len(tokenizer.vocab), 1)
            )
            params = init_minilm_params(cfg, seed=seed)
        self.device = torch.device(device)
        self.params = params
        self.model = MiniLM.from_state_dict(
            cfg, minilm_state_dict_from_jax(params)
        ).to(self.device)
        self.cfg = self.model.cfg
        self.graphs: Optional[GraphSet] = None

    @property
    def tokenizer_impl(self) -> str:
        """Which tokenizer implementation encode() uses — recorded in
        the store manifest so query-side tokenization always matches
        the one that embedded the documents."""
        return "native-cpp" if self._fast_tokenizer is not None else "python"

    @property
    def fast_tokenizer(self):
        """The tokenizer of ``tokenize`` and ``encode``: the C++ one where
        it was taken, else the Python one."""
        return self._fast_tokenizer or self.tokenizer

    def tokenize(self, texts: Sequence[str]) -> List[np.ndarray]:
        """Token ids of each text, int32, at most ``cfg.max_len``."""
        tokenizer = self.fast_tokenizer
        return [
            np.asarray(tokenizer.encode(t, max_len=self.cfg.max_len),
                       np.int32)
            for t in texts
        ]

    def encode_ids(
        self, encoded: Sequence[np.ndarray], batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Encode tokenized texts in length-sorted device batches;
        returns ``[B, H]`` float32 in input order."""
        batch_size = batch_size or self.cfg.encode_batch
        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        out = np.empty((len(encoded), self.cfg.hidden), dtype=np.float32)
        for lo in range(0, len(order), batch_size):
            idx = order[lo:lo + batch_size]
            ids, mask = pad_and_bucket(
                [encoded[i] for i in idx], self.cfg.max_len,
                self.tokenizer.pad_id,
            )
            (out[idx],) = run_program(
                self.graphs, ("encode", *ids.shape), self._forward,
                {"ids": ids, "mask": mask}, self.device)
        return out

    def _forward(self, ids: torch.Tensor, mask: torch.Tensor):
        with torch.inference_mode():
            return (minilm_encode(self.model, ids, mask),)

    def encode(
        self,
        texts: Sequence[str],
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Encode texts in device batches; returns ``[B, H]`` float32
        unit rows."""
        if not texts:
            return np.zeros((0, self.cfg.hidden), dtype=np.float32)
        return self.encode_ids(self.tokenize(texts), batch_size)
