"""Train and gate the cross-encoder reranker of an existing store.

Trains at the bi-encoder's optimization scale (default 4000 steps) with
the warmup-cosine schedule and the random-then-hard curriculum on the
card, then runs the index build's validation gate (held-out title MRR, the
alpha blend fit) and persists the checkpoint into the store ONLY on a
pass. The last line is a JSON object: steps, passed, alpha, train_s.

Usage:  RR_STEPS=4000 python -m legal_rag_tpu_torch.scripts.train_reranker STORE_DIR

Environment: ``RR_STEPS`` (steps), ``RR_SIBLING`` (sibling-positive
probability; 0 keeps the span/title recipe), ``RR_FRESH=1`` (drop a
checkpoint the store already carries before training, so a rejection
is not masked by the old one), ``RR_SAVE=0`` (do not write the store),
``RR_DEVICE`` (default cuda).
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    store_dir = argv[0]
    steps = int(os.environ.get("RR_STEPS", 4000))
    sibling = float(os.environ.get("RR_SIBLING", "0"))
    device = os.environ.get("RR_DEVICE", "cuda")

    from legal_rag_tpu_torch.config import EncoderConfig, RetrievalConfig
    from legal_rag_tpu_torch.index.builder import _train_validated_reranker
    from legal_rag_tpu_torch.index.store import VectorStore
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    print(f"device={device}  store={store_dir}  steps={steps}", flush=True)
    store = VectorStore.load(store_dir)
    info = dict(store.encoder_info)
    seed = info.pop("seed", 0)
    tok_impl = info.pop("tokenizer_impl", "python")
    cfg = dc.replace(
        EncoderConfig(),
        **{k: v for k, v in info.items()
           if k in EncoderConfig.__dataclass_fields__},
    )
    enc = SentenceEncoder(
        cfg=cfg, tokenizer=WordPieceTokenizer(store.wp_vocab), seed=seed,
        params=store.encoder_params, prefer_tokenizer=tok_impl,
        device=device,
    )
    texts = [c["text"] for c in store.chunks]

    if os.environ.get("RR_FRESH", "0") == "1" and store.ce_params is not None:
        store.ce_params = None
        print("pre-existing cross-encoder checkpoint dropped (RR_FRESH=1)",
              flush=True)

    t0 = time.time()
    _train_validated_reranker(
        store, enc, texts, steps, RetrievalConfig(),
        log_fn=lambda m: print(f"[{time.time()-t0:6.0f}s] {m}", flush=True),
        sibling_prob=sibling, device=device,
    )
    passed = store.ce_params is not None
    print(json.dumps({
        "steps": steps,
        "passed": bool(passed),
        "alpha": getattr(store, "ce_alpha", None) if passed else None,
        "train_s": round(time.time() - t0, 1),
    }), flush=True)
    if passed and os.environ.get("RR_SAVE", "1") == "1":
        store.save(store_dir)
        print(f"checkpoint persisted into {store_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
