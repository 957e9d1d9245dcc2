"""Dense-sweep roofline experiments on one CUDA card: where the
column-major two-phase search's phase 1 loses bandwidth against one pass
over the doc matrix. The counterpart of the JAX package's
``scripts/exp_dense_roofline.py``, section by section:

  xla     torch ops: matmul + the port's tie-ordered top-k ("prod"),
          matmul + sum, matmul + segment max, and matmul + the two-phase
          select with fp32 and with bf16 scores
  stream  kernel X1 (:mod:`legal_rag_tpu_torch.ops.stream_probe`): only
          reads the doc blocks, the achievable read rate
  matmul  kernel X2 (:mod:`legal_rag_tpu_torch.ops.mm_rowmax`): the
          tensor cores' product + a row max on top of the stream
  segmax  kernel K4 (:func:`legal_rag_tpu_torch.ops.segmax_cm.segmax_cm`)
          at (block_n, seg_rows) as the JAX script sweeps them
  p2      phase 2's pieces at width N/8: top-kk, the hierarchical max +
          top-k, the two-level select by gather and by one-hot matmul,
          the member gather + rescore from ``[D, N]``, the take-along

Docs are ``N`` (``EXP_N``, default 1,000,000) seeded unit rows of 384
dims stored transposed in bf16, 64 queries; ``EXP_SECTIONS`` picks
sections (comma-separated), ``EXP_ONLY_P2=1`` runs p2 alone. GB/s is
the bf16 doc matrix's size over the row's time, as in the JAX script.
The TPU's ``approx_max_k`` and its compiler knobs have no counterpart
on the card: their rows say so and time nothing.

Run on the card:  python -m legal_rag_tpu_torch.scripts.exp_dense_roofline
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from legal_rag_tpu_torch.ops.dense import (
    gather_supers, lax_top_k, matmul_scores, select_segments,
)
from legal_rag_tpu_torch.ops.mm_rowmax import mm_rowmax
from legal_rag_tpu_torch.ops.segmax_cm import segmax_cm
from legal_rag_tpu_torch.ops.stream_probe import stream_probe
from legal_rag_tpu_torch.scripts.exp_common import (
    D, K, Q, SR, Log, card_main, generator, note_row, onehot_member_values,
    timed_row, unit_rows,
)

N = 1_000_000
SECTIONS = ("xla", "stream", "matmul", "segmax", "p2")
STREAM_BN = (8192, 16384, 32768, 65536)
MATMUL_BN = (8192, 16384, 32768)
SEGMAX_CASES = ((8192, 8), (16384, 8), (16384, 16), (32768, 8), (32768, 16),
                (32768, 32))
P2_KK = K + 64
LANES = 128                       # the super-segment width of the selects
NO_APPROX = ("no counterpart on the card: torch has no approximate top-k, "
             "and nothing is substituted")


def pad_cols(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x [D, n]`` zero-padded to a multiple of ``multiple`` columns."""
    n = x.shape[1]
    return F.pad(x, (0, -(-n // multiple) * multiple - n)).contiguous()


def make_data(n: int, device, seed: int = 0):
    """``(q16 [Q, D], dt16 [D, n])`` bf16 from seeded unit rows."""
    g = generator(device, seed)
    docs_t = unit_rows(g, n, D, device).T.to(torch.bfloat16).contiguous()
    q16 = unit_rows(g, Q, D, device).to(torch.bfloat16)
    return q16, docs_t


def two_phase(s: torch.Tensor, kk: int):
    """The select of the JAX script's ``xla_two_phase`` over a full
    score matrix ``s [Q, npad]``: segment maxima, the two-level select of
    ``kk`` segments, the top-K of their members read back from ``s``."""
    m = s.view(Q, -1, SR).amax(dim=2).float()
    top_seg = select_segments(m, kk, sup=LANES)
    mem_ids = (top_seg[:, :, None] * SR
               + torch.arange(SR, device=s.device)).reshape(Q, kk * SR)
    v, pos = torch.topk(s.gather(1, mem_ids).float(), K, dim=1)
    return v.sum() + mem_ids.gather(1, pos).sum()


def section_xla(q16, dt16, n, device, log, timing) -> List[Dict]:
    gb = n * D * 2
    dxp = pad_cols(dt16, SR * LANES)
    kk = min(P2_KK, dxp.shape[1] // SR // LANES)
    scores = lambda: matmul_scores(q16, dxp.T)          # [Q, npad] fp32
    return [
        timed_row("xla dot+top_k (prod)",
                  lambda: lax_top_k(scores(), K), device, log, *timing,
                  n_bytes=gb),
        timed_row("xla dot+sum   (floor)", lambda: scores().sum(), device,
                  log, *timing, n_bytes=gb),
        timed_row("xla dot+segmax reduce",
                  lambda: scores().view(Q, -1, SR).amax(dim=2).sum(), device,
                  log, *timing, n_bytes=gb),
        timed_row("xla dot+two-phase f32", lambda: two_phase(scores(), kk),
                  device, log, *timing, n_bytes=gb),
        timed_row("xla dot+two-phase bf16 scores",
                  lambda: two_phase(q16 @ dxp, kk), device, log, *timing,
                  n_bytes=gb),
        note_row("xla dot+approx_max_k", NO_APPROX, log),
    ]


def section_stream(dt16, n, bns, device, log, timing) -> List[Dict]:
    rows = []
    for bn in bns:
        dpad = pad_cols(dt16, bn)
        rows.append(timed_row(f"stream bn={bn:6d}",
                              lambda: stream_probe(dpad, bn)[1], device, log,
                              *timing, n_bytes=n * D * 2, block_n=bn))
        del dpad
    return rows


def section_matmul(q16, dt16, n, bns, device, log, timing) -> List[Dict]:
    rows = []
    for bn in bns:
        dpad = pad_cols(dt16, bn)
        # the TPU probe's output: the last block's row max, summed
        rows.append(timed_row(f"matmul bn={bn:6d}",
                              lambda: mm_rowmax(q16, dpad, bn)[:, -1:].sum(),
                              device, log, *timing, n_bytes=n * D * 2,
                              block_n=bn))
        del dpad
    return rows


def section_segmax(q16, dt16, n, cases, device, log, timing) -> List[Dict]:
    rows = []
    for bn, sr in cases:
        dpad = pad_cols(dt16, bn)          # the padding is masked (n_valid)
        rows.append(timed_row(f"segmax bn={bn:6d} sr={sr:2d}",
                              lambda: segmax_cm(q16, dpad, n, sr).sum(),
                              device, log, *timing, n_bytes=n * D * 2,
                              block_n=bn, seg_rows=sr))
        del dpad
    for knob in ("dims=('parallel', 'arbitrary')",
                 "dims=('arbitrary', 'arbitrary')", "vmem=100MB"):
        rows.append(note_row(
            f"segmax bn=16384 sr=8 {knob}",
            "a TPU compiler knob (dimension_semantics / vmem_limit_bytes); "
            "no counterpart on the card", log))
    return rows


def section_p2(q16, dt16, n, device, seed, log, timing) -> List[Dict]:
    g = generator(device, seed + 1)
    width = n // SR
    segm = torch.randn(Q, width, generator=g, device=device)
    wpad = -(-width // LANES) * LANES
    nsup = wpad // LANES
    kk = min(P2_KK, nsup)
    ids = torch.randint(0, n, (Q, kk * SR), generator=g, device=device)
    sids = torch.randint(0, width, (Q, kk), generator=g, device=device)

    def hier():
        sp = F.pad(segm, (0, wpad - width), value=float("-inf"))
        s, idx = torch.topk(sp.view(Q, nsup, LANES).amax(dim=2), kk, dim=1)
        return s.sum() + idx.sum()

    def two_level(member_values, pad):
        # pad finite for the one-hot product (0 * -inf is NaN)
        s3 = F.pad(segm, (0, wpad - width), value=pad).view(Q, nsup, LANES)
        sup = torch.topk(s3.amax(dim=2), kk, dim=1).indices
        s, pos = torch.topk(member_values(s3, sup), kk, dim=1)
        return s.sum() + pos.sum()

    def gather_rescore():
        gathered = dt16[:, ids]                              # [D, Q, C]
        return torch.einsum("qd,dqc->qc", q16.float(), gathered.float()).sum()

    return [
        timed_row(f"p2 top_k [{Q},{width}] kk={kk}",
                  lambda: torch.topk(segm, kk, dim=1, sorted=False)[0].sum(),
                  device, log, *timing),
        note_row("p2 approx_max_k", NO_APPROX, log),
        timed_row(f"p2 hier max128+top_k [{Q},{nsup}]", hier, device, log,
                  *timing),
        timed_row(f"p2 two-level select kk={kk}",
                  lambda: two_level(gather_supers, float("-inf")), device,
                  log, *timing),
        timed_row(f"p2 two-level one-hot kk={kk}",
                  lambda: two_level(onehot_member_values, -1e30), device,
                  log, *timing),
        timed_row(f"p2 gather+rescore [{Q},{kk * SR}] cols", gather_rescore,
                  device, log, *timing),
        timed_row(f"p2 take_along_axis [{Q},{kk}] of [Q,{width}]",
                  lambda: segm.gather(1, sids).sum(), device, log, *timing),
    ]


def run(n: int = N, sections: Iterable[str] = SECTIONS, device="cuda",
        seed: int = 0, log: Log = print, iters: int = 20, warmup: int = 3,
        stream_bn: Sequence[int] = STREAM_BN,
        matmul_bn: Sequence[int] = MATMUL_BN,
        segmax_cases: Sequence[Tuple[int, int]] = SEGMAX_CASES) -> List[Dict]:
    """The chosen sections' rows (module doc), each tagged with its
    ``section``. Times only on a CUDA device."""
    device = torch.device(device)
    sections = set(sections)
    timing = (iters, warmup)
    q16, dt16 = make_data(n, device, seed)
    parts = {
        "xla": lambda: section_xla(q16, dt16, n, device, log, timing),
        "stream": lambda: section_stream(dt16, n, stream_bn, device, log,
                                         timing),
        "matmul": lambda: section_matmul(q16, dt16, n, matmul_bn, device,
                                         log, timing),
        "segmax": lambda: section_segmax(q16, dt16, n, segmax_cases, device,
                                         log, timing),
        "p2": lambda: section_p2(q16, dt16, n, device, seed, log, timing),
    }
    out: List[Dict] = []
    for name in SECTIONS:
        if name in sections:
            out += [dict(row, section=name) for row in parts[name]()]
    return out


def sections_from_env() -> List[str]:
    if os.environ.get("EXP_ONLY_P2") == "1":
        return ["p2"]
    return os.environ.get("EXP_SECTIONS", ",".join(SECTIONS)).split(",")


def main() -> int:
    n = int(os.environ.get("EXP_N", N))
    sections = sections_from_env()

    def body(log: Log) -> None:
        log(f"N={n} D={D} Q={Q} k={K} bf16 sections={','.join(sections)}")
        run(n, sections, "cuda", log=log)

    return card_main("exp_dense_roofline", body)


if __name__ == "__main__":
    sys.exit(main())
