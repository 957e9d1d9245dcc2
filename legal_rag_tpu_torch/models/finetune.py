"""Encoder fine-tuning loop: corpus-driven contrastive adaptation.

The port of ``legal_rag_tpu.models.finetune`` on one device. The pair
streams (``make_pairs``, ``make_sibling_pairs``, ``augment_query``,
``section_groups``) and their constants are the JAX package's host code
verbatim, so one seed draws the same (pseudo-query, positive) batches
in both packages; :func:`finetune_encoder` drives the InfoNCE step of
:mod:`legal_rag_tpu_torch.models.train` over them with torch's AdamW.
The JAX version's ``mesh`` argument is gone: one device holds the whole
batch (multi-GPU is ROADMAP P13).
"""

from __future__ import annotations

import copy
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.models.convert import minilm_params_from_state_dict
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.train import adamw, make_train_step

# Swept default (BASELINE.md recipe sweep: 4000 steps / p_sib 0.6 wins
# both eval splits). The index build's fingerprint derives its tag
# from THIS constant, so changing the recipe invalidates stale stores.
SIBLING_PROB_DEFAULT = 0.6

# Statute-register -> everyday-register phrasings (round 5, VERDICT r4
# items 3+5). The paraphrase E2E diagnosis (scripts/diag_paraphrase.py)
# showed 5/8 failures are encoder misses: real victim queries use
# everyday vocabulary ("grabbed my gold chain and sprinted off") that
# never occurs in the statute-text spans the contrastive finetune
# trains on, so the encoder has no bridge between the registers. This
# table substitutes statute terms inside training spans with everyday
# forms — the inverse direction of the classifier's _OFFENCE_FORMS map
# (retrieval/classifier.py:59-95), which canonicalizes user phrasings
# to offence entities. Multi-form values: one is sampled per hit.
REGISTER_FORMS = {
    "theft": ("stole my things", "stolen", "took my belongings"),
    "robbery": ("robbed", "mugged at gunpoint"),
    "snatching": ("grabbed my chain and ran off", "snatched from me"),
    "assault": ("attacked", "beaten up"),
    "rape": ("raped",),
    "kidnapping": ("took away a child", "lured away"),
    "abduction": ("taken away by force",),
    "stalking": ("keeps following me around", "following me everywhere"),
    "defamation": ("spreading made-up stories about me",
                   "ruined my standing in the community"),
    "cheating": ("sold me fake goods", "defrauded me"),
    "extortion": ("blackmailed", "demanding money with threats"),
    "acid": ("corrosive liquid",),
    "dowry": ("demanding cash and gifts from my family",),
    "detention": ("held by the police",),
    "custody": ("held at the police station",),
    "compensation": ("payment for my hospital bills",
                     "money for the victim"),
    "imprisonment": ("jail time",),
    "grievous": ("serious", "severe"),
    "hurt": ("injury",),
    "intercourse": ("sexual act",),
    "voluntarily": ("on purpose",),
    "dishonestly": ("intending to cheat",),
    "movable property": ("belongings",),
    "examination": ("check-up by a doctor",),
    "magistrate": ("judge",),
    "cognizable": ("serious police-registrable",),
}


AUGMENT_KINDS_DEFAULT = ("register", "dropout", "unique")


def augment_query(
    span: str,
    pos_text: str,
    rng: np.random.Generator,
    drop_prob: float = 0.15,
    kinds: Tuple[str, ...] = AUGMENT_KINDS_DEFAULT,
) -> str:
    """One augmentation of a training span, sampled among three kinds:

    - ``register``: statute terms in the span replaced with everyday
      phrasings (REGISTER_FORMS) — trains the victim-register bridge.
    - ``dropout``: each word dropped with ``drop_prob`` (>=2 kept) —
      robustness to missing vocabulary.
    - ``unique``: the span is REBUILT from the source tokens absent
      from the positive text (the paraphrase_pairs_from_chunks
      construction, evaluation.py:77) — the hardest bridging signal:
      zero lexical overlap with the positive by construction.

    Falls back to dropout when a kind is inapplicable (no register hit,
    no unique tokens), so the stream never stalls. ``kinds`` restricts
    the sampled set (``--finetune-augment-kinds``): the uniform 3-kind
    mix at P=0.3 measured as a regression on every gate (BASELINE.md
    round-5 augmentation table), so variants isolate which kind earns
    its keep.
    """
    kind = kinds[int(rng.integers(len(kinds)))]
    words = span.split()
    if kind == "register":
        lowered = " " + span.lower() + " "
        hits = [t for t in REGISTER_FORMS if f" {t} " in lowered
                or lowered.strip().startswith(t + " ")
                or lowered.strip().endswith(" " + t)]
        if hits:
            out = span
            for t in hits:
                forms = REGISTER_FORMS[t]
                repl = forms[int(rng.integers(len(forms)))]
                # whole-word, case-insensitive, first occurrence
                import re

                out = re.sub(
                    rf"(?i)\b{re.escape(t)}\b", repl, out, count=1
                )
            return out
        kind = "dropout"
    if kind == "unique" and pos_text:
        pos_toks = {w for w in pos_text.lower().split() if w.isalpha()}
        uniq = [w for w in words
                if w.isalpha() and w.lower() not in pos_toks]
        if len(uniq) >= 3:
            return " ".join(uniq[:16])
        kind = "dropout"
    if len(words) <= 2:
        return span
    keep = [w for w in words if rng.random() >= drop_prob]
    if len(keep) < 2:
        keep = words[:2]
    return " ".join(keep)


def make_pairs(
    texts: Sequence[str],
    rng: np.random.Generator,
    span_words: Tuple[int, int] = (3, 9),
) -> Iterator[Tuple[str, str]]:
    """Endless (pseudo-query, positive-chunk) pair stream.

    Uses plain whitespace tokens (an isalpha filter here once caused an
    unbounded rejection loop on corpora of mostly non-alpha tokens);
    texts shorter than one word are skipped, and a corpus with no
    usable text raises instead of spinning.
    """
    usable = [t for t in texts if t.split()]
    if not usable:
        raise ValueError("no non-empty texts to build training pairs from")
    n = len(usable)
    while True:
        text = usable[int(rng.integers(n))]
        words = text.split()
        take = int(rng.integers(span_words[0], span_words[1]))
        take = min(take, len(words))
        lo = int(rng.integers(0, len(words) - take + 1))
        yield " ".join(words[lo : lo + take]), text


def section_groups(chunks: Sequence[dict]) -> List[List[int]]:
    """Group chunk indices by legal unit (section / SOP chapter / NALSA
    clause) — the same keying the paraphrase eval split uses
    (evaluation.paraphrase_pairs_from_chunks), so sibling positives
    train exactly the cross-chunk bridging that split measures."""
    groups = {}
    for i, chunk in enumerate(chunks):
        meta = chunk.get("metadata", {})
        law = meta.get("law")
        key = None
        if law in ("BNS", "BNSS", "BSA") and meta.get("section"):
            key = (law, str(meta.get("section")))
        elif law == "SOP" and meta.get("chapter_title"):
            key = (law, meta.get("chapter_title"))
        elif law == "NALSA" and meta.get("clause"):
            key = (law, str(meta.get("clause")))
        if key is not None:
            groups.setdefault(key, []).append(i)
    return [groups[k] for k in sorted(groups)]


def make_sibling_pairs(
    chunks: Sequence[dict],
    rng: np.random.Generator,
    span_words: Tuple[int, int] = (3, 13),
    sibling_prob: float = SIBLING_PROB_DEFAULT,
    augment_prob: float = 0.0,
    augment_kinds: Tuple[str, ...] = AUGMENT_KINDS_DEFAULT,
) -> Iterator[Tuple[str, str]]:
    """Pair stream mixing two positive distributions.

    With probability ``1 - sibling_prob`` the positive is the span's own
    chunk (lexical anchoring, as :func:`make_pairs`); with probability
    ``sibling_prob`` it is a random OTHER chunk of the same section.
    Same-chunk pairs teach span→chunk matching; sibling pairs teach the
    section-level semantic bridging that pure span training never
    learns — round 2's span-only encoder scored chance (0.003 r@10) on
    the lexical-gap paraphrase split because nothing had ever pulled
    sibling chunks together in embedding space.

    ``augment_prob`` (round 5): probability that the query span is
    transformed by :func:`augment_query` (register substitution / word
    dropout / unique-token rebuild) — the victim-register and
    vocabulary-robustness signal the paraphrase E2E diagnosis showed
    the pooled recipe lacks. 0.0 = the round-4 recipe, byte-identical.
    """
    texts = [c["text"] for c in chunks]
    usable = [i for i, t in enumerate(texts) if t.split()]
    if not usable:
        raise ValueError("no non-empty texts to build training pairs from")
    multi = [g for g in section_groups(chunks) if len(g) >= 2]

    def span_of(i: int) -> str:
        words = texts[i].split()
        take = int(rng.integers(span_words[0], span_words[1]))
        take = min(take, len(words))
        lo = int(rng.integers(0, len(words) - take + 1))
        return " ".join(words[lo : lo + take])

    while True:
        if multi and rng.random() < sibling_prob:
            group = multi[int(rng.integers(len(multi)))]
            src = group[int(rng.integers(len(group)))]
            rest = [i for i in group if i != src]
            pos = rest[int(rng.integers(len(rest)))]
            if not texts[src].split():
                continue
            q, p = span_of(src), texts[pos]
        else:
            i = usable[int(rng.integers(len(usable)))]
            q, p = span_of(i), texts[i]
        if augment_prob and rng.random() < augment_prob:
            q = augment_query(q, p, rng, kinds=augment_kinds)
        yield q, p


def fixed_length(a: np.ndarray, rows: int, max_len: int, fill: int,
                 device) -> torch.Tensor:
    """``a [rows, <= max_len]`` padded with ``fill`` to ``[rows,
    max_len]`` on ``device``: the JAX package's fixed-length training
    batches (masked positions leave the loss unchanged)."""
    out = np.full((rows, max_len), fill, dtype=np.int32)
    out[:, : a.shape[1]] = a
    return torch.from_numpy(out).to(device)


def finetune_encoder(
    encoder: SentenceEncoder,
    texts: Sequence[str],
    steps: int = 100,
    batch_size: int = 32,
    learning_rate: float = 2e-5,
    temperature: float = 0.05,
    seed: int = 0,
    log_every: int = 20,
    log_fn=None,
    chunks: Optional[Sequence[dict]] = None,
    sibling_prob: float = SIBLING_PROB_DEFAULT,
    token_maxsim_weight: float = 0.0,
    augment_prob: float = 0.0,
    augment_kinds: Tuple[str, ...] = AUGMENT_KINDS_DEFAULT,
) -> Tuple[SentenceEncoder, List[float]]:
    """Fine-tune a copy of ``encoder``'s weights on its device; returns
    a NEW SentenceEncoder holding the trained params (tokenizer shared)
    plus the loss history. ``encoder`` itself is left as it was.

    Negatives are the whole batch. ``token_maxsim_weight`` blends in the
    token-level late-interaction term (models/train.py
    contrastive_loss); 0.0 = the pooled-only recipe. The pairs are drawn
    from ``np.random.default_rng(seed)`` in the JAX package's order.
    """
    device = encoder.device
    model = copy.deepcopy(encoder.model)
    optimizer = adamw(model.parameters(), learning_rate)
    step = make_train_step(
        model, optimizer, temperature=temperature,
        maxsim_weight=token_maxsim_weight,
    )

    rng = np.random.default_rng(seed)
    if chunks is not None:
        pair_stream = make_sibling_pairs(
            chunks, rng, sibling_prob=sibling_prob,
            augment_prob=augment_prob, augment_kinds=augment_kinds,
        )
    else:
        pair_stream = make_pairs(texts, rng)
    max_len = min(encoder.cfg.max_len, 128)
    pad = encoder.tokenizer.pad_id
    losses: List[float] = []
    for i in range(steps):
        queries, docs = zip(*(next(pair_stream) for _ in range(batch_size)))
        q_ids, q_mask = encoder.tokenizer.encode_batch(queries, max_len=max_len)
        d_ids, d_mask = encoder.tokenizer.encode_batch(docs, max_len=max_len)
        loss = step(
            fixed_length(q_ids, batch_size, max_len, pad, device),
            fixed_length(q_mask, batch_size, max_len, 0, device),
            fixed_length(d_ids, batch_size, max_len, pad, device),
            fixed_length(d_mask, batch_size, max_len, 0, device),
        )
        losses.append(float(loss))
        if log_fn and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i}: loss {losses[-1]:.4f}")

    tuned = SentenceEncoder(
        cfg=encoder.cfg, params=minilm_params_from_state_dict(model.state_dict()),
        tokenizer=encoder.tokenizer, seed=encoder.seed, device=device,
    )
    return tuned, losses
