"""A markdown corpus in the shape of the five legal corpora, from a seed.

:func:`write_legal_corpus` writes the directory layout that
``ingest.parse_corpus`` reads (``BNS/``, ``BNSS/``, ``BSA/`` chapter
files, ``nalsa.md``, ``nalsa_table.md``, ``General SOP.md``,
``sop_rape_against_women.md``) in the markdown constructs the parser
recognizes: chapters with a title line, ``## Section N — Title``
sections split into ``**(n)**`` sub-sections, NALSA clauses and a
compensation table, and SOP topics split by ``---`` with numbered steps.
At ``n_chunks=2620`` the chunk count per law is the serving corpus's
(BNS 815, BNSS 1,339, BSA 325, NALSA 67, SOP 74), and a chunk holds
about 104 BM25 tokens (about 620 characters), as the serving corpus's
mean chunk does. Titles are drawn from legal phrases and their words
recur in their own chunks' bodies, so a title retrieves its section.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

# chunks per law in the serving corpus (2,620 in all)
SERVING_COUNTS = {"BNS": 815, "BNSS": 1339, "BSA": 325, "NALSA": 67,
                  "SOP": 74}

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
    # Zipf ranks: short words first (frequent), each length in random order
    long = sorted(words - set(short))
    return ([str(x) for x in rng.permutation(syl + short)]
            + [str(x) for x in rng.permutation(long)])


class _Writer:
    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.vocab = _vocabulary(rng)
        p = 1.0 / np.arange(1, len(self.vocab) + 1) ** 1.05
        self.p = p / p.sum()

    def title(self) -> str:
        rng = self.rng
        return (f"{_HEADS[int(rng.integers(len(_HEADS)))]} "
                f"{_OBJECTS[int(rng.integers(len(_OBJECTS)))]}")

    def body(self, topic: str, lo: int = 40, hi: int = 130) -> str:
        """About ``lo``-``hi`` words: the topic's words, stopwords and a
        Zipf draw over the vocabulary, in sentences."""
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


def _statute(w: _Writer, law: str, n_chunks: int, docs: Path) -> int:
    """Chapter files of sections; a section is its intro chunk plus 0-3
    sub-section chunks. Returns the chunks written."""
    rng = w.rng
    (docs / law).mkdir(parents=True, exist_ok=True)
    written, section, chapter = 0, 1, 0
    while written < n_chunks:
        lines = [f"# CHAPTER {_ROMAN[chapter % len(_ROMAN)]}",
                 f"## {_CHAPTERS[int(rng.integers(len(_CHAPTERS)))]}", ""]
        for _ in range(int(rng.integers(15, 40))):
            if written >= n_chunks:
                break
            title = w.title()
            lines += [f"## Section {section} — {title}", w.body(title), ""]
            written += 1
            for sub in range(1, int(rng.integers(0, 4)) + 1):
                if written >= n_chunks:
                    break
                lines += [f"**({sub})** {w.body(title)}", ""]
                written += 1
            section += 1
        chapter += 1
        path = docs / law / f"chapter_{chapter:02d}.md"
        path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return written


def _nalsa(w: _Writer, n_chunks: int, docs: Path) -> int:
    """Clauses (``## n. TITLE``, split by ``---``) in nalsa.md and table
    rows in nalsa_table.md, about 60/40."""
    rng = w.rng
    n_rows = max(1, (2 * n_chunks) // 5)
    n_clause = max(1, n_chunks - n_rows - 1)      # the header row's chunk
    lines, written, clause = [], 0, 1
    while written < n_clause:
        title = w.title().upper()
        lines.append(f"## {clause}. {title}")
        for part in range(int(rng.integers(1, 4))):
            if written >= n_clause:
                break
            if part:
                lines.append("---")
            lines += [w.body(title), ""]
            written += 1
        clause += 1
    (docs / "nalsa.md").write_text("\n".join(lines) + "\n", encoding="utf-8")
    rows = ["| S. No. | Particulars of loss or injury | Minimum Limit of "
            "Compensation | Upper Limit of Compensation |",
            "| --- | --- | --- | --- |"]
    for r in range(1, n_rows + 1):
        loss = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
        lo = int(rng.integers(1, 6))
        rows.append(f"| {r} | Loss or injury by {loss}: "
                    f"{w.body(loss, 8, 20)} | Rs. {lo} Lakh | "
                    f"Rs. {lo + int(rng.integers(1, 6))} Lakh |")
    (docs / "nalsa_table.md").write_text("\n".join(rows) + "\n",
                                         encoding="utf-8")
    return written + n_rows + 1


def _sop(w: _Writer, n_chunks: int, docs: Path) -> int:
    """General SOP topics (``## **SOP ON ...**``, split by ``---``) and
    the rape SOP's numbered steps under one topic, about 60/40."""
    rng = w.rng
    n_steps = max(1, (2 * n_chunks) // 5)
    n_general = max(1, n_chunks - n_steps)
    lines, written = [], 0
    while written < n_general:
        topic = w.title().upper()
        lines.append(f"## **SOP ON {topic}**")
        for part in range(int(rng.integers(1, 4))):
            if written >= n_general:
                break
            if part:
                lines.append("---")
            lines += [w.body(topic), ""]
            written += 1
    (docs / "General SOP.md").write_text("\n".join(lines) + "\n",
                                         encoding="utf-8")
    lines = ["## **SOP ON INVESTIGATION OF RAPE AGAINST WOMEN**", ""]
    for s in range(1, n_steps + 1):
        step = w.title()
        lines += [f"**{s:02d}. {step} — Suggested Action**", w.body(step), ""]
    (docs / "sop_rape_against_women.md").write_text("\n".join(lines) + "\n",
                                                     encoding="utf-8")
    return written + n_steps


def write_legal_corpus(docs_dir, n_chunks: int = 2620,
                       seed: int = 0) -> Dict[str, int]:
    """Write the five corpora under ``docs_dir`` for about ``n_chunks``
    chunks, split as the serving corpus is; returns the chunks written
    per law (what ``parse_corpus`` then reads back)."""
    docs = Path(docs_dir)
    docs.mkdir(parents=True, exist_ok=True)
    w = _Writer(np.random.default_rng(seed))
    total = sum(SERVING_COUNTS.values())
    want = {law: max(3, round(c * n_chunks / total))
            for law, c in SERVING_COUNTS.items()}
    counts = {law: _statute(w, law, want[law], docs) for law in _STATUTES}
    counts["NALSA"] = _nalsa(w, want["NALSA"], docs)
    counts["SOP"] = _sop(w, want["SOP"], docs)
    return counts
