"""The plain hybrid search and the rule that judges the program's rows.

Semantics (the served configuration's, ``legal_rag_tpu_torch/config.py``
as the configuration file states them): the dense channel ranks every
doc by the inner product of the query's unit embedding with the doc's;
the sparse channel by BM25 (``bm25.py``). With ``C`` dense candidates
(``candidate_multiplier * k``):

- ``rrf``: each doc scores ``sum 1 / (rrf_k + rank)`` over the two
  channels' top-C lists (1-based ranks), the top ``k`` by that score;
- ``weighted``: over the dense top-C only, ``dense * (1 - w) + bm25 /
  max(bm25) * w`` (the max over the corpus, 1 where it is 0), the top
  ``k``.

:func:`band_needed` judges the program's rows for one query against
the exact float64 channel scores: the least tie band ``tau`` (from a
fixed grid) under which every returned doc sits where its exact scores
allow when docs within ``tau`` of each other may trade places, its
returned scores are what those places give, and no doc that would surely
beat the last returned one is missing. Sound rows need a band of
rounding size; a wrong doc needs one of the score gap it jumps.

:func:`plain_rows` is the reference's own answer (ties by ascending
id), which the control puts in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

# the grid of tie bands, in units of the dense score (a cosine); the
# sparse channel's band is tau * max(1, the query's best BM25 score)
BANDS = (0.0, 1e-7, 3e-7, 1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3,
         1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0)
NO_BAND = 10.0
SCORE_TOL = 1e-5    # a returned fused score against the one its places give


class Channels:
    """One query's exact channel scores, sorted once for rank counts."""

    def __init__(self, dense: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor):
        self.dense, self.lo, self.hi = dense, lo, hi
        self.n = int(dense.shape[0])
        self.dense_asc = torch.sort(dense).values
        self.lo_asc = torch.sort(lo).values
        self.hi_asc = torch.sort(hi).values
        self.bm_scale = max(1.0, float(hi.max()) if self.n else 1.0)

    def _count_gt(self, asc, x):
        return self.n - torch.searchsorted(asc, x, right=True)

    def _count_ge(self, asc, x):
        return self.n - torch.searchsorted(asc, x, right=False)

    def dense_ranks(self, ids: torch.Tensor, tau: float):
        """1-based rank range of ``ids`` in the dense channel."""
        s = self.dense[ids]
        return (1 + self._count_gt(self.dense_asc, s + tau),
                self._count_ge(self.dense_asc, s - tau))

    def sparse_ranks(self, ids: torch.Tensor, tau: float):
        tb = tau * self.bm_scale
        return (1 + self._count_gt(self.lo_asc, self.hi[ids] + tb),
                self._count_ge(self.hi_asc, self.lo[ids] - tb))


def _rrf_bounds(ch: Channels, ids: torch.Tensor, tau: float, c: int,
                rrf_k: int):
    """Least and greatest RRF score that ``ids`` can have."""
    f_lo = torch.zeros(len(ids), dtype=torch.float64, device=ids.device)
    f_hi = torch.zeros_like(f_lo)
    for r_lo, r_hi in (ch.dense_ranks(ids, tau), ch.sparse_ranks(ids, tau)):
        f_hi += torch.where(r_lo <= c, 1.0 / (rrf_k + r_lo.double()), 0.0)
        f_lo += torch.where(r_hi <= c, 1.0 / (rrf_k + r_hi.double()), 0.0)
    return f_lo, f_hi


def _candidates(ch: Channels, c: int) -> torch.Tensor:
    """Docs that can hold a top-C place in either channel."""
    m = min(c, ch.n)
    return torch.unique(torch.cat([torch.topk(ch.dense, m).indices,
                                   torch.topk(ch.lo, m).indices,
                                   torch.topk(ch.hi, m).indices]))


def rows_hold(ch: Channels, rows: Sequence[Tuple[int, float, float, float]],
              mode: str, k: int, c: int, rrf_k: int, weight: float,
              tau: float) -> bool:
    """Whether the program's ``rows`` (doc id, fused score, semantic,
    keyword) for one query hold under the tie band ``tau``."""
    want = min(k, ch.n)
    if len(rows) != want:
        return False
    ids_list = [r[0] for r in rows]
    if len(set(ids_list)) != len(ids_list):
        return False
    if any(d < 0 or d >= ch.n for d in ids_list):
        return False
    dev = ch.dense.device
    ids = torch.as_tensor(ids_list, device=dev)
    fused = torch.as_tensor([r[1] for r in rows], dtype=torch.float64,
                            device=dev)
    if bool((fused[1:] > fused[:-1] + SCORE_TOL).any()):
        return False
    cand = _candidates(ch, c)
    others = cand[~torch.isin(cand, ids)]
    if mode == "rrf":
        f_lo, f_hi = _rrf_bounds(ch, ids, tau, c, rrf_k)
        if bool(((fused < f_lo - SCORE_TOL) | (fused > f_hi + SCORE_TOL)).any()):
            return False
        o_lo, _ = _rrf_bounds(ch, others, tau, c, rrf_k)
        return not bool((o_lo > fused[-1] + SCORE_TOL).any())
    # weighted: the fusion of the dense candidates
    tb = tau * ch.bm_scale
    g_lo = float(ch.lo.max()) or 1.0
    g_hi = float(ch.hi.max()) or 1.0
    sem = torch.as_tensor([r[2] for r in rows], dtype=torch.float64, device=dev)
    key = torch.as_tensor([r[3] for r in rows], dtype=torch.float64, device=dev)
    r_lo, _ = ch.dense_ranks(ids, tau)
    if bool((r_lo > c).any()):
        return False
    if bool(((sem - ch.dense[ids]).abs() > tau).any()):
        return False
    if bool(((key < (ch.lo[ids] - tb) / g_hi - tau)
             | (key > (ch.hi[ids] + tb) / g_lo + tau)).any()):
        return False
    if bool(((fused - (sem * (1 - weight) + key * weight)).abs()
             > SCORE_TOL).any()):
        return False
    _, o_hi = ch.dense_ranks(others, tau)
    sure = others[o_hi <= c]
    o_fused = ((ch.dense[sure] - tau) * (1 - weight)
               + ((ch.lo[sure] - tb) / g_hi - tau) * weight)
    return not bool((o_fused > fused[-1] + SCORE_TOL).any())


def band_needed(ch: Channels, rows, mode: str, k: int, c: int, rrf_k: int,
                weight: float) -> float:
    """The least band of :data:`BANDS` under which the rows hold, else
    :data:`NO_BAND`."""
    for tau in BANDS:
        if rows_hold(ch, rows, mode, k, c, rrf_k, weight, tau):
            return tau
    return NO_BAND


def _top(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Top-``m`` ids by score descending, ties by ascending id."""
    order = torch.sort(scores, descending=True, stable=True).indices
    return order[:m]


def plain_rows(dense: torch.Tensor, bm25: torch.Tensor, mode: str, k: int,
               c: int, rrf_k: int, weight: float) -> List[Tuple]:
    """The reference's rows for one query: ``(doc, fused, semantic,
    keyword)``, semantic and keyword 0 under RRF."""
    n = int(dense.shape[0])
    c = min(c, n)
    d_ids = _top(dense, c).tolist()
    if mode == "rrf":
        s_ids = _top(bm25, c).tolist()
        score: Dict[int, float] = {}
        for lst in (d_ids, s_ids):
            for r, d in enumerate(lst, start=1):
                score[d] = score.get(d, 0.0) + 1.0 / (rrf_k + r)
        best = sorted(score.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [(d, f, 0.0, 0.0) for d, f in best]
    gmax = float(bm25.max()) or 1.0
    rows = []
    for d in d_ids:
        sem, key = float(dense[d]), float(bm25[d]) / gmax
        rows.append((d, sem * (1 - weight) + key * weight, sem, key))
    rows.sort(key=lambda r: -r[1])
    return rows[:k]
