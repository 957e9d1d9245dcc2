"""Random-init against fine-tuned encoder: retrieval recall@k and MRR in
every mode (``evaluation.compare_encoders``) over a markdown corpus, on
one device. The counterpart of the JAX package's
``scripts/eval_ablation.py``, which read a fixed corpus directory and
wrote the repository's EVAL_RETRIEVAL.json; this one takes the corpus
as ``--docs`` and prints the report as JSON (``--report PATH`` also
writes it), so it leaves the repository's EVAL_*.json alone.

Run:  python -m legal_rag_tpu_torch.scripts.eval_ablation --docs DIR
      [--steps 400] [--batch 64] [--max-pairs N] [--device cuda]
      [--report build/eval_ablation.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

from legal_rag_tpu_torch.config import DEFAULT_CONFIG, RetrievalConfig


def run(docs: str, finetune_steps: int = 400, finetune_batch: int = 64,
        ks: Sequence[int] = (1, 5, 10), max_pairs: Optional[int] = None,
        config: RetrievalConfig = DEFAULT_CONFIG, device="cuda",
        log=print) -> Dict:
    """``compare_encoders`` over the chunks of the markdown in ``docs``."""
    from legal_rag_tpu_torch.evaluation import compare_encoders
    from legal_rag_tpu_torch.index.builder import _chunk_dicts
    from legal_rag_tpu_torch.ingest import parse_corpus

    t0 = time.time()
    chunks = _chunk_dicts(parse_corpus(docs))
    log(f"{len(chunks)} chunks parsed ({time.time() - t0:.1f}s)")
    return compare_encoders(
        chunks, config=config, finetune_steps=finetune_steps,
        finetune_batch=finetune_batch, ks=ks, max_pairs=max_pairs,
        log_fn=lambda msg: log(f"[{time.time() - t0:7.1f}s] {msg}"),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", required=True, help="markdown corpus directory")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    report = run(args.docs, args.steps, args.batch, max_pairs=args.max_pairs,
                 device=args.device,
                 log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
