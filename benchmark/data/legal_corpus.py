"""The five laws' corpus from a seed, as chunk dicts.

A frozen copy of ``legal_rag_tpu_torch/ingest/synthetic.py``
(``write_legal_corpus``): the same draws in the same order (chapters of
``Section N — Title`` sections split into sub-sections for BNS, BNSS and
BSA; NALSA clauses and compensation-table rows; General-SOP topics and
the rape SOP's numbered steps), at the serving corpus's split of 2,620
chunks (BNS 815, BNSS 1,339, BSA 325, NALSA 67, SOP 74). Its texts are
shorter than the serving corpus's and draw on fewer words (about 85
BM25 tokens a chunk and 8,400 terms, against 104 and 12,630): the
configuration's ``assumed`` gives the measured numbers. Where the
original writes markdown for the port's parser, this copy emits the
chunks in the store's ``chunks.json`` form (``text``,
``canonical_header``, ``section_id``, ``metadata`` with ``law``,
``section`` and ``unit_type``), so the benchmark hands both
sides the same chunks and parses nothing: sub-sections point at their
section, so parent expansion has work; laws and units drive the
orchestrator's rule boosts.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SERVING_COUNTS = {"BNS": 815, "BNSS": 1339, "BSA": 325, "NALSA": 67,
                  "SOP": 74}
LAW_NAMES = {"BNS": "Bharatiya Nyaya Sanhita",
             "BNSS": "Bharatiya Nagarik Suraksha Sanhita",
             "BSA": "Bharatiya Sakshya Adhiniyam",
             "NALSA": "NALSA Compensation Scheme", "SOP": "General SOP"}

_HEADS = (
    "Punishment for", "Procedure for", "Powers of", "Rights of",
    "Duty of", "Protection of", "Examination of", "Compensation for",
    "Definition of", "Attempt to commit", "Abetment of", "Evidence of",
    "Admissibility of", "Arrest of", "Custody of", "Bail in", "Trial of",
    "Summons to", "Warrant for", "Search of", "Investigation of",
    "Inquiry into", "Presumption as to", "Limitation for", "Appeal against",
)
_OBJECTS = (
    "robbery", "theft", "murder", "kidnapping", "assault", "cheating",
    "extortion", "defamation", "stalking", "dowry death", "acid attack",
    "grievous hurt", "criminal trespass", "forgery", "bribery", "rioting",
    "public servant", "witness", "accused person", "victim",
    "police officer", "magistrate", "electronic record", "confession",
    "documentary evidence", "zero fir", "medical examination",
    "sexual harassment", "wrongful restraint", "criminal intimidation",
    "house breaking", "dacoity", "counterfeit currency", "false evidence",
    "public nuisance", "unlawful assembly", "criminal breach of trust",
    "mischief by fire", "abduction of a minor", "organised crime",
    "terrorist act", "snatching", "cruelty by husband", "voyeurism",
    "attempt to suicide",
)
_CHAPTERS = (
    "GENERAL PROVISIONS", "OFFENCES AGAINST THE BODY", "OF PUNISHMENTS",
    "OFFENCES AGAINST PROPERTY", "OFFENCES RELATING TO DOCUMENTS",
    "ARREST OF PERSONS", "PROCESSES TO COMPEL APPEARANCE",
    "INFORMATION TO THE POLICE", "RELEVANCY OF FACTS",
    "PROOF OF DOCUMENTS", "OF WITNESSES", "OFFENCES AGAINST WOMEN",
)
_ROMAN = ("I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X",
          "XI", "XII", "XIII", "XIV", "XV", "XVI", "XVII", "XVIII", "XIX",
          "XX", "XXI", "XXII", "XXIII", "XXIV", "XXV", "XXVI", "XXVII",
          "XXVIII", "XXIX", "XXX", "XXXI", "XXXII", "XXXIII", "XXXIV",
          "XXXV", "XXXVI", "XXXVII", "XXXVIII", "XXXIX", "XL")
_STOP = ("the", "of", "and", "to", "a", "in", "shall", "be", "any", "or",
         "by", "with", "such", "is", "for", "who", "under", "may", "that")
_STATUTES = ("BNS", "BNSS", "BSA")


def _vocabulary(rng: np.random.Generator, n: int = 6000) -> List[str]:
    syl = ["ka", "ra", "ti", "mo", "sen", "dar", "vik", "lu", "pra", "jan",
           "dha", "ni", "sha", "ve", "tor", "mal", "gu", "rek", "so", "bha"]
    short = [a + b for a in syl for b in syl]
    words = set(short)
    while len(words) < n:
        words.add("".join(syl[int(j)] for j in rng.integers(len(syl), size=3)))
    long = sorted(words - set(short))
    return ([str(x) for x in rng.permutation(syl + short)]
            + [str(x) for x in rng.permutation(long)])


class _Writer:
    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.vocab = _vocabulary(rng)
        p = 1.0 / np.arange(1, len(self.vocab) + 1) ** 1.05
        self.p = p / p.sum()
        self.chunks: List[Dict] = []

    def title(self) -> str:
        rng = self.rng
        return (f"{_HEADS[int(rng.integers(len(_HEADS)))]} "
                f"{_OBJECTS[int(rng.integers(len(_OBJECTS)))]}")

    def body(self, topic: str, lo: int = 40, hi: int = 130) -> str:
        rng = self.rng
        n = int(rng.integers(lo, hi))
        topic_words = topic.lower().split()
        u = rng.random(n)
        pick_topic = rng.integers(len(topic_words), size=n)
        pick_stop = rng.integers(len(_STOP), size=n)
        pick_word = rng.choice(len(self.vocab), size=n, p=self.p)
        words = [
            topic_words[t] if x < 0.12 else _STOP[s] if x < 0.40
            else self.vocab[v]
            for x, t, s, v in zip(u, pick_topic, pick_stop, pick_word)
        ]
        cuts = np.cumsum(rng.integers(8, 16, size=n))
        cuts = [0] + [int(c) for c in cuts if c < n] + [n]
        return " ".join(
            " ".join(words[a:b]).capitalize() + "."
            for a, b in zip(cuts, cuts[1:]) if b > a
        )

    def add(self, law: str, header: str, text: str, section_id: str,
            section: str, unit_type: str, **meta) -> None:
        self.chunks.append({
            "text": text,
            "canonical_header": f"{LAW_NAMES[law]}\n{header}",
            "section_id": section_id,
            "metadata": {"law": law, "law_name": LAW_NAMES[law],
                         "section": section, "unit_type": unit_type, **meta},
        })


def _statute(w: _Writer, law: str, n_chunks: int) -> None:
    rng = w.rng
    written, section, chapter = 0, 1, 0
    while written < n_chunks:
        chap = f"CHAPTER {_ROMAN[chapter % len(_ROMAN)]}"
        chap_title = _CHAPTERS[int(rng.integers(len(_CHAPTERS)))]
        for _ in range(int(rng.integers(15, 40))):
            if written >= n_chunks:
                break
            title = w.title()
            head = f"{chap} {chap_title}\nSection {section} — {title}"
            w.add(law, head, f"{title}. {w.body(title)}", f"{law}_{section}",
                  str(section), "section", chapter=chap,
                  section_title=title)
            written += 1
            for sub in range(1, int(rng.integers(0, 4)) + 1):
                if written >= n_chunks:
                    break
                w.add(law, f"{head}\n({sub})", f"({sub}) {w.body(title)}",
                      f"{law}_{section}({sub})", str(section), "sub_section",
                      chapter=chap, section_title=title)
                written += 1
            section += 1
        chapter += 1


def _nalsa(w: _Writer, n_chunks: int) -> None:
    rng = w.rng
    n_rows = max(1, (2 * n_chunks) // 5)
    n_clause = max(1, n_chunks - n_rows - 1)
    written, clause = 0, 1
    while written < n_clause:
        title = w.title().upper()
        for part in range(int(rng.integers(1, 4))):
            if written >= n_clause:
                break
            w.add("NALSA", f"{clause}. {title}" + (f" ({part + 1})" if part
                                                    else ""),
                  f"{title}. {w.body(title)}", f"NALSA_C{clause}",
                  f"C{clause}", "clause" if not part else "clause_part")
            written += 1
        clause += 1
    w.add("NALSA", "Schedule header", "S. No. Particulars of loss or injury "
          "Minimum Limit of Compensation Upper Limit of Compensation",
          "NALSA_T0", "T0", "table_row")
    for r in range(1, n_rows + 1):
        loss = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
        lo = int(rng.integers(1, 6))
        text = (f"{r} Loss or injury by {loss}: {w.body(loss, 8, 20)} "
                f"Rs. {lo} Lakh Rs. {lo + int(rng.integers(1, 6))} Lakh")
        w.add("NALSA", f"Schedule row {r}", text, f"NALSA_T{r}", f"T{r}",
              "table_row")


def _sop(w: _Writer, n_chunks: int) -> None:
    rng = w.rng
    n_steps = max(1, (2 * n_chunks) // 5)
    n_general = max(1, n_chunks - n_steps)
    written, topic_no = 0, 0
    while written < n_general:
        topic = w.title().upper()
        topic_no += 1
        for part in range(int(rng.integers(1, 4))):
            if written >= n_general:
                break
            w.add("SOP", f"SOP ON {topic}" + (f" ({part + 1})" if part else ""),
                  f"SOP ON {topic}. {w.body(topic)}",
                  f"GSOP_{written + 1:03d}", f"G{topic_no}", "sop_topic")
            written += 1
    for s in range(1, n_steps + 1):
        step = w.title()
        w.add("SOP", f"SOP ON INVESTIGATION OF RAPE AGAINST WOMEN\n"
              f"{s:02d}. {step}", f"{step} — Suggested Action. "
              f"{w.body(step)}", f"RSOP_{s:02d}", f"R{s}", "step")


def legal_chunks(seed: int, n_chunks: int = 2620) -> List[Dict]:
    """About ``n_chunks`` chunks of the five laws, split as the serving
    corpus is, from ``seed``."""
    w = _Writer(np.random.default_rng(seed))
    total = sum(SERVING_COUNTS.values())
    want = {law: max(3, round(c * n_chunks / total))
            for law, c in SERVING_COUNTS.items()}
    for law in _STATUTES:
        _statute(w, law, want[law])
    _nalsa(w, want["NALSA"])
    _sop(w, want["SOP"])
    return w.chunks


def make(config: Dict, seed: int, device):
    """The ``legal_corpus`` store of ``config``: the chunks above, unit
    doc embeddings, the encoders' weights and a vocabulary built from the
    chunks' text; the program indexes the texts for BM25 itself."""
    from benchmark.data.inputs import Inputs, padded_wordpiece_vocab
    from benchmark.data.weights import (
        cross_encoder_params, minilm_params, unit_embeddings,
    )
    from benchmark.reference.bm25 import vocab_from_texts

    enc = config["encoder"]
    chunks = legal_chunks(seed, config["n_chunks"])
    texts = [c["text"] for c in chunks]
    wp_vocab = padded_wordpiece_vocab(texts, enc["vocab_size"])
    vocab, flat, lengths = vocab_from_texts(texts)
    return Inputs(
        chunks=chunks,
        embeddings=unit_embeddings(seed, len(chunks), enc["hidden"],
                                   device).cpu().numpy(),
        wp_vocab=wp_vocab,
        encoder_params=minilm_params(seed, "encoder", enc, len(wp_vocab),
                                     device),
        ce_params=cross_encoder_params(seed, config["cross_encoder"],
                                       len(wp_vocab), device),
        ce_alpha=config["cross_encoder"]["alpha"],
        bm25_tokens=flat, bm25_lengths=lengths, bm25_vocab=vocab,
    )
