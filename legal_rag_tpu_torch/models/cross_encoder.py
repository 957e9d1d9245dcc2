"""Cross-encoder reranker: joint (query, document) scoring.

The query and a candidate run through one BERT forward as a
``[CLS] q [SEP] d [SEP]`` pair with segment ids; a linear head on the
masked mean-pooled hidden states emits the relevance score. Pair
encoding, ``rerank``, ``blend_scores``, the heading-form policy and the
BM25 hard-negative miner are the JAX package's host code verbatim; the
forward is :func:`cross_encode_scores` on the port's :class:`MiniLM`.

Training is the JAX package's listwise recipes on ``torch.autograd``
with optax.adamw's update (``models.train.adamw``): in-batch
(:func:`train_cross_encoder`) and hard-negative groups with a
random-then-mined curriculum under optax's warmup-cosine schedule
(:func:`train_cross_encoder_hard`), drawing from one numpy seed in the
JAX package's order. A fresh cross-encoder starts from the bi-encoder's
trunk (copied, so training leaves the bi-encoder as it was) and a
numpy-initialized head.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from legal_rag_tpu_torch.models.convert import (
    minilm_params_from_state_dict, minilm_state_dict_from_jax,
)
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.minilm import MiniLM, minilm_hidden_states
from legal_rag_tpu_torch.models.train import adamw
from legal_rag_tpu_torch.models.wordpiece import pad_and_bucket
from legal_rag_tpu_torch.utils.graphs import run_program
from legal_rag_tpu_torch.utils.timing import StageTimer, timed


def cross_encode_scores(
    trunk: MiniLM,
    head_w: torch.Tensor,           # [H]
    head_b: torch.Tensor,           # [] scalar
    input_ids: torch.Tensor,        # [B, L] pair-encoded
    attention_mask: torch.Tensor,
    token_type_ids: torch.Tensor,
) -> torch.Tensor:
    """Relevance score per pair ``[B]``: linear head on the masked
    mean-pooled hidden states."""
    hidden = minilm_hidden_states(
        trunk, input_ids, attention_mask, token_type_ids=token_type_ids,
    )
    m = attention_mask[:, :, None].to(hidden.dtype)
    pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    return pooled @ head_w + head_b


class CrossEncoder:
    """Pair scorer sharing the bi-encoder's tokenizer and device.

    ``params``: adopt a trained ``{"trunk", "head"}`` checkpoint (a
    store's ``cross_encoder.npz``) instead of a fresh head (N(0, 0.02)
    from ``seed`` by numpy, zero bias) on a copy of the bi-encoder's
    trunk. ``params`` (the attribute) reads the current weights back as
    that pytree, so a trained cross-encoder saves as the JAX one does.
    ``timer``: where ``score_pairs`` is timed as the stage ``ce`` (a
    serving engine's ``StageTimer``; else one of its own), its pair
    encoding inside it as ``ce_tokenize``.

    ``score_pairs`` encodes its pairs with the implementation the
    encoder's tokenizer pinned (``pair_encoder_impl``): where that is the
    C++ one, ``NativeWordPiece.encode_pairs`` in one call that holds no
    GIL; else ``encode_pairs`` on the Python tokenizer. The two give the
    same rows wherever the tokenizers agree. ``pair_encodes`` counts the
    calls by implementation.
    """

    def __init__(
        self, encoder: SentenceEncoder, seed: int = 0, params=None,
        timer: Optional[StageTimer] = None,
    ):
        self.cfg = encoder.cfg
        self.timer = timer if timer is not None else StageTimer()
        self.tokenizer = encoder.tokenizer
        self.pair_encoder_impl = encoder.tokenizer_impl
        self._native_pairs = (
            encoder.fast_tokenizer.encode_pairs
            if self.pair_encoder_impl == "native-cpp" else None
        )
        self.pair_encodes = {"native-cpp": 0, "python": 0}
        self._count_lock = threading.Lock()
        self.device = encoder.device
        # the encoder's captured programs (a serving engine's), if any:
        # score_pairs replays one graph per [rows, L] pair batch
        self.graphs = encoder.graphs
        if params is None:
            rng = np.random.default_rng(seed)
            params = {
                "trunk": encoder.params,
                "head": {
                    "w": (0.02 * rng.standard_normal(self.cfg.hidden)).astype(
                        np.float32
                    ),
                    "b": np.zeros((), np.float32),
                },
            }
        self.trunk = MiniLM.from_state_dict(
            self.cfg, minilm_state_dict_from_jax(params["trunk"])
        ).to(self.device)
        self.head_w = torch.nn.Parameter(torch.tensor(
            np.asarray(params["head"]["w"], np.float32), device=self.device
        ))
        self.head_b = torch.nn.Parameter(torch.tensor(
            np.asarray(params["head"]["b"], np.float32), device=self.device
        ))

    @property
    def params(self) -> Dict:
        """The weights as the JAX package's ``{"trunk", "head"}`` pytree
        of float32 numpy arrays."""
        return {
            "trunk": minilm_params_from_state_dict(self.trunk.state_dict()),
            "head": {"w": self.head_w.detach().cpu().numpy().copy(),
                     "b": self.head_b.detach().cpu().numpy().copy()},
        }

    def parameters(self) -> List[torch.nn.Parameter]:
        return [*self.trunk.parameters(), self.head_w, self.head_b]

    def scores(self, ids, mask, tt) -> torch.Tensor:
        """Relevance ``[B]`` of pair-encoded rows on the device, with
        autograd (training) or without (inside ``inference_mode``)."""
        return cross_encode_scores(
            self.trunk, self.head_w, self.head_b, ids, mask, tt
        )

    # -- pair encoding -------------------------------------------------------

    def encode_pairs(
        self,
        queries: Sequence[str],
        docs: Sequence[str],
        max_len: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``[CLS] q [SEP] d [SEP]`` ids + mask + segment ids, padded to
        a shared pow2 length bucket. The query keeps at most half the
        budget so the document is never squeezed out."""
        tok = self.tokenizer
        max_len = max_len or min(self.cfg.max_len, 256)
        q_budget = max_len // 2 - 2
        encoded, types = [], []
        for q, d in zip(queries, docs):
            q_ids = tok.encode(q, max_len=max_len, add_special=False)
            q_ids = q_ids[:q_budget]
            d_cap = max_len - len(q_ids) - 3
            d_ids = tok.encode(d, max_len=max_len, add_special=False)[:d_cap]
            ids = (
                [tok.cls_id] + q_ids + [tok.sep_id] + d_ids + [tok.sep_id]
            )
            encoded.append(ids)
            types.append([0] * (len(q_ids) + 2) + [1] * (len(d_ids) + 1))
        ids, mask = pad_and_bucket(encoded, max_len, tok.pad_id)
        tt = np.zeros_like(ids)
        for i, t in enumerate(types):
            t = t[: ids.shape[1]]
            tt[i, : len(t)] = t
        return ids, mask, tt

    # -- scoring -------------------------------------------------------------

    @timed("ce")
    def score_pairs(
        self, queries: Sequence[str], docs: Sequence[str]
    ) -> np.ndarray:
        encode = self._native_pairs or self.encode_pairs
        with self.timer.stage("ce_tokenize"):
            ids, mask, tt = encode(queries, docs, min(self.cfg.max_len, 256))
        with self._count_lock:
            self.pair_encodes[self.pair_encoder_impl] += 1
        (scores,) = run_program(
            self.graphs, ("cross_encode", *ids.shape), self._forward,
            {"ids": ids, "mask": mask, "tt": tt}, self.device)
        return scores

    def _forward(self, ids, mask, tt):
        with torch.inference_mode():
            return (self.scores(ids, mask, tt),)

    def rerank(
        self,
        query: str,
        docs: Sequence[str],
        top_m: Optional[int] = None,
        base_scores: Optional[Sequence[float]] = None,
        alpha: float = 1.0,
    ) -> List[int]:
        """Indices of ``docs`` reordered by joint relevance (desc,
        stable).

        With ``base_scores`` the CE acts as a REFINEMENT, not a
        replacement: both score vectors min-max normalize over the pool
        and blend as ``(1-alpha)*base + alpha*ce``. ``alpha`` is fit by
        the build-time gate (index/builder.py) on held-out queries —
        small alphas let a CE with real-but-noisy signal improve the
        base order without the authority to destroy it."""
        scores = self.score_pairs([query] * len(docs), list(docs))
        if base_scores is not None and alpha < 1.0:
            scores = blend_scores(scores, np.asarray(base_scores), alpha)
        order = np.argsort(-scores, kind="stable")
        return order[: top_m or len(docs)].tolist()


def blend_scores(
    ce_scores: np.ndarray, base_scores: np.ndarray, alpha: float
) -> np.ndarray:
    """``(1-alpha)*minmax(base) + alpha*minmax(ce)`` over one candidate
    pool. Normalizing per pool makes the two scales commensurable
    (CE logits are unbounded; base scores are fusion scores)."""

    def norm(x):
        x = np.asarray(x, np.float64)
        lo, hi = float(x.min()), float(x.max())
        return (x - lo) / ((hi - lo) or 1.0)

    return (1.0 - alpha) * norm(base_scores) + alpha * norm(ce_scores)


# Queries at most this many words count as "heading-like" — the
# register the CE was trained on (title -> chunk pairs with BM25 hard
# negatives, train_cross_encoder_hard). EVAL_CE_PARAPHRASE.json
# measures the CE's value by query form: heading-register (structure
# split, titles) peaks at alpha=0.7 (+0.052 MRR, CI>0) while long
# descriptive queries (paraphrase split, 12-word spans) are already
# significantly HURT at alpha=0.3 — the blend should follow the form.
HEADING_MAX_WORDS = 8


def ce_policy_alpha(
    query: str,
    serving_alpha: float,
    heading_alpha: "Optional[float]" = None,
    distress: bool = False,
) -> float:
    """Per-query CE blend weight: give the reranker authority only on
    queries inside its training distribution.

    ``heading_alpha`` (measured structure-split optimum) applies to
    short heading-like queries; everything else — long descriptive
    queries and any victim-distress query — keeps the conservative
    ``serving_alpha`` the build gate fit. Disabled (pure
    ``serving_alpha``) when ``heading_alpha`` is None. The policy's
    per-split value is measured by scripts/eval_ce_paraphrase.py's
    policy rows, not assumed.
    """
    if heading_alpha is None or distress:
        return serving_alpha
    if len(query.split()) <= HEADING_MAX_WORDS:
        return heading_alpha
    return serving_alpha


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` as a plain function of the
    update count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine to ``end_value`` by ``decay_steps``
    (the total, warmup included), in float32 as optax computes it.
    optax reads it at the count before the update, so the first update
    runs at ``init_value``: set the optimizer's lr to ``schedule(i)``
    before update ``i``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps - warmup_steps}."
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        # float32 arithmetic in optax's order, so the values agree with
        # optax's to float32 rounding
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
                warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = min(f32(count - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / cos_steps))
        decayed = f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


def _listwise_step(ce: CrossEncoder, optimizer, loss_of_scores):
    def step(ids, mask, tt) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of_scores(ce.scores(ids, mask, tt))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_ce_train_step(ce: CrossEncoder, optimizer):
    """Listwise in-batch training step: row i's positive is doc i; all
    other rows' docs are its negatives. One ``[B*B, L]`` pair forward
    per step (B small), softmax CE on the diagonal. ``step(ids, mask,
    tt) -> loss`` updates ``ce`` in place."""

    def loss(scores):
        b = math.isqrt(scores.shape[0])
        logp = torch.log_softmax(scores.reshape(b, b), dim=1)
        return -torch.mean(torch.diagonal(logp))

    return _listwise_step(ce, optimizer, loss)


def make_ce_train_step_grouped(ce: CrossEncoder, optimizer, group: int):
    """Listwise training step over explicit candidate groups: pair rows
    arrive query-major as ``[B*group, L]`` with each query's POSITIVE in
    column 0 and its mined hard negatives after it."""

    def loss(scores):
        logp = torch.log_softmax(scores.reshape(-1, group), dim=1)
        return -torch.mean(logp[:, 0])

    return _listwise_step(ce, optimizer, loss)


def make_hard_negative_miner(texts: Sequence[str]):
    """BM25 hard-negative miner (VERDICT r2 item 4): for a query,
    return the indices of the lexically closest corpus chunks — the
    candidates a retrieval stage would actually surface, and therefore
    the confusions the cross-encoder must learn to resolve. In-batch
    random negatives (the round-2 recipe) never show the model a
    near-miss, which is why that checkpoint failed its gate.

    Returns ``mine(query, exclude, n_neg, rng) -> List[int]``;
    ``exclude`` ids (the query's true positives) never appear."""
    from legal_rag_tpu_torch.ops.sparse import build_bm25

    idx = build_bm25(texts)

    def mine(query, exclude, n_neg, rng):
        excl = set(int(e) for e in np.atleast_1d(exclude))
        scores = np.zeros(idx.n_docs, np.float32)
        counts: Dict[int, int] = {}
        for t in idx.query_term_ids(query):
            counts[t] = counts.get(t, 0) + 1
        for t, c in counts.items():
            lo, hi = int(idx.indptr[t]), int(idx.indptr[t + 1])
            np.add.at(
                scores, idx.doc_ids[lo:hi], c * idx.weights[lo:hi]
            )
        top = np.argsort(-scores, kind="stable")[: 3 * n_neg + len(excl)]
        cands = [int(d) for d in top if int(d) not in excl and scores[d] > 0]
        if len(cands) > n_neg:
            sel = rng.choice(len(cands), size=n_neg, replace=False)
            cands = [cands[int(j)] for j in sel]
        while len(cands) < n_neg:          # pad with random negatives
            d = int(rng.integers(idx.n_docs))
            if d not in excl:
                cands.append(d)
        return cands

    return mine


def _fixed_pairs(ce: CrossEncoder, grid_q, grid_d, max_len: int):
    """Pair rows padded to exactly ``max_len`` on the device: the JAX
    package's fixed-length training batches."""
    ids, mask, tt = ce.encode_pairs(grid_q, grid_d, max_len=max_len)
    full = np.full((ids.shape[0], max_len), ce.tokenizer.pad_id, np.int32)
    full[:, : ids.shape[1]] = ids
    fm = np.zeros_like(full)
    fm[:, : mask.shape[1]] = mask
    ft = np.zeros_like(full)
    ft[:, : tt.shape[1]] = tt
    return tuple(torch.from_numpy(a).to(ce.device) for a in (full, fm, ft))


def train_cross_encoder_hard(
    ce: CrossEncoder,
    texts: Sequence[str],
    chunks: Optional[Sequence[dict]] = None,
    steps: int = 600,
    batch_queries: int = 8,
    n_neg: int = 7,
    learning_rate: float = 5e-5,
    max_len: int = 128,
    seed: int = 0,
    log_fn=None,
    title_pairs: Optional[Sequence[Tuple[str, Sequence[int]]]] = None,
    title_prob: float = 0.5,
    warmup_frac: float = 0.25,
    n_hard: Optional[int] = None,
    sibling_prob: float = 0.0,
) -> List[float]:
    """Hard-negative listwise training, in place: the JAX package's
    recipe (models/cross_encoder.py there documents it).

    Each step scores ``batch_queries`` groups of ``1 + n_neg`` docs
    (positive first). Queries mix corpus spans and, with ``chunks``
    metadata (or ``title_pairs``), section titles whose whole relevant
    set is kept out of the negatives; with ``sibling_prob`` a group's
    positive is another chunk of the span's section. The first
    ``warmup_frac`` of steps use random negatives only, then ``n_hard``
    (default ceil(n_neg/2)) BM25-mined ones join the random fill. The
    lr follows optax's warmup-cosine schedule (warmup steps // 10,
    floor 5% of the peak).
    """
    from legal_rag_tpu_torch.models.finetune import make_pairs, section_groups

    rng = np.random.default_rng(seed)
    mine = make_hard_negative_miner(texts)
    span_stream = make_pairs(texts, rng)
    # positives keyed by text value, every duplicate excluded from the
    # negatives (a textual twin of the positive is no negative)
    span_index: dict = {}
    for _i, _t in enumerate(texts):
        span_index.setdefault(_t, []).append(_i)

    if title_pairs is None:
        title_pairs = []
        if chunks is not None:
            from legal_rag_tpu_torch.evaluation import labeled_pairs_from_chunks

            title_pairs = labeled_pairs_from_chunks(chunks)

    sib_groups: List[List[int]] = []
    if sibling_prob > 0:
        if chunks is None:
            raise ValueError("sibling_prob > 0 requires chunks metadata")
        sib_groups = [g for g in section_groups(chunks) if len(g) >= 2]
        if not sib_groups:
            sibling_prob = 0.0

    if n_hard is None:
        n_hard = -(-n_neg // 2)

    def rand_negs(exclude, count):
        out: List[int] = []
        excl = set(int(e) for e in exclude)
        while len(out) < count:
            d = int(rng.integers(len(texts)))
            if d not in excl:
                out.append(d)
        return out

    def sample_sibling_group():
        g = sib_groups[int(rng.integers(len(sib_groups)))]
        src = int(g[int(rng.integers(len(g)))])
        others = [i for i in g if i != src]
        pos = int(others[int(rng.integers(len(others)))])
        words = texts[src].split()
        if not words:
            return None
        take = min(int(rng.integers(3, 13)), len(words))
        lo = int(rng.integers(0, len(words) - take + 1))
        q = " ".join(words[lo:lo + take])
        return q, pos, list(g)

    def sample_group(hard: int):
        u = rng.random()
        if sib_groups and u < sibling_prob:
            sampled = sample_sibling_group()
            if sampled is not None:
                q, pos, exclude = sampled
                negs = mine(q, exclude, hard, rng) if hard else []
                negs += rand_negs(list(exclude) + negs, n_neg - len(negs))
                return q, [texts[pos]] + [texts[d] for d in negs]
            u = 1.0  # empty source chunk: fall through to the mix below
        if title_pairs and u < sibling_prob + title_prob * (
            1.0 - sibling_prob
        ):
            q, rel = title_pairs[int(rng.integers(len(title_pairs)))]
            pos = int(rel[int(rng.integers(len(rel)))])
            exclude = rel
        else:
            q, pos_text = next(span_stream)
            same = span_index[pos_text]
            pos = same[0]
            exclude = list(same)
        negs = mine(q, exclude, hard, rng) if hard else []
        negs += rand_negs(list(exclude) + negs, n_neg - len(negs))
        return q, [texts[pos]] + [texts[d] for d in negs]

    group = 1 + n_neg
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=max(1, steps // 10), decay_steps=steps,
        end_value=learning_rate * 0.05,
    )
    optimizer = adamw(ce.parameters(), schedule(0))
    step = make_ce_train_step_grouped(ce, optimizer, group)
    max_len = min(max_len, ce.cfg.max_len)

    warmup = int(steps * warmup_frac)
    losses: List[float] = []
    for i in range(steps):
        hard = 0 if i < warmup else n_hard
        grid_q: List[str] = []
        grid_d: List[str] = []
        for _ in range(batch_queries):
            q, docs = sample_group(hard)
            grid_q.extend([q] * group)
            grid_d.extend(docs)
        for g in optimizer.param_groups:
            g["lr"] = schedule(i)
        losses.append(float(step(*_fixed_pairs(ce, grid_q, grid_d, max_len))))
        if log_fn and (i % 20 == 0 or i == steps - 1):
            log_fn(f"ce-hard step {i}: loss {losses[-1]:.4f}")
    return losses


def train_cross_encoder(
    ce: CrossEncoder,
    texts: Sequence[str],
    steps: int = 100,
    batch_size: int = 8,
    learning_rate: float = 2e-5,
    max_len: int = 128,
    seed: int = 0,
    log_fn=None,
) -> List[float]:
    """In-place listwise training on corpus span pairs. ``batch_size``
    queries per step -> ``batch_size**2`` pair forwards; keep it small.
    """
    from legal_rag_tpu_torch.models.finetune import make_pairs

    rng = np.random.default_rng(seed)
    stream = make_pairs(texts, rng)
    optimizer = adamw(ce.parameters(), learning_rate)
    step = make_ce_train_step(ce, optimizer)
    max_len = min(max_len, ce.cfg.max_len)

    losses: List[float] = []
    for i in range(steps):
        queries, docs = zip(*(next(stream) for _ in range(batch_size)))
        # full B x B pair grid, row-major (query major)
        grid_q = [q for q in queries for _ in range(batch_size)]
        grid_d = [d for _ in range(batch_size) for d in docs]
        losses.append(float(step(*_fixed_pairs(ce, grid_q, grid_d, max_len))))
        if log_fn and (i % 20 == 0 or i == steps - 1):
            log_fn(f"ce step {i}: loss {losses[-1]:.4f}")
    return losses
