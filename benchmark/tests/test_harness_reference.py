"""The plain reference against hand-computed BM25, RRF and a one-layer
MiniLM at a tiny size."""

import math

import numpy as np
import torch

from benchmark.reference.bm25 import PlainBM25, vocab_from_texts
from benchmark.reference.minilm import PlainCrossEncoder, PlainEncoder, PlainMiniLM
from benchmark.reference.search import (
    NO_BAND, Channels, band_needed, plain_rows,
)
from benchmark.reference.wordpiece import build_wordpiece_vocab

DOCS = ["the cat sat", "the dog sat down", "a cat and a dog", "birds fly"]


def bm25(texts=DOCS):
    vocab, flat, lengths = vocab_from_texts(texts)
    return PlainBM25(torch.as_tensor(flat), torch.as_tensor(lengths), vocab)


def test_bm25_by_hand():
    ref = bm25()
    lens = [3, 4, 5, 2]
    avgdl = sum(lens) / 4
    raw = {t: math.log(4 - df + 0.5) - math.log(df + 0.5)
           for t, df in {"the": 2, "cat": 2, "sat": 2, "dog": 2, "down": 1,
                         "a": 1, "and": 1, "birds": 1, "fly": 1}.items()}
    mean = sum(raw.values()) / len(raw)
    idf = {t: (0.25 * mean if v < 0 else v) for t, v in raw.items()}

    def w(t, tf, d):
        return idf[t] * tf * 2.5 / (tf + 1.5 * (0.25 + 0.75 * lens[d] / avgdl))
    lo, hi = ref.scores("cat dog dog")
    want = [w("cat", 1, 0), w("dog", 1, 1) * 2, w("cat", 1, 2) + 2 * w("dog", 1, 2), 0]
    np.testing.assert_allclose(lo.numpy(), want, rtol=1e-12)
    assert torch.equal(lo, hi)
    # "a" appears twice in doc 2: tf 2
    lo, _ = ref.scores("a")
    np.testing.assert_allclose(lo[2].item(), w("a", 2, 2), rtol=1e-12)


def test_bm25_cap_keeps_the_heaviest_and_brackets_ties():
    ref = bm25()
    full, _ = ref.scores("the sat")          # 4 postings
    lo, hi = ref.scores("the sat", cap=2)
    assert bool((lo <= full + 1e-12).all()) and bool((hi >= lo).all())
    # every posting of "the" and "sat" weighs by doc length only: the
    # two heaviest are doc 0's, so doc 0 keeps both
    np.testing.assert_allclose(lo[0].item(), full[0].item(), rtol=1e-12)
    assert ref.n_postings("the sat the") == 4


def test_rrf_by_hand_and_band():
    dense = torch.tensor([0.9, 0.8, 0.1, 0.5], dtype=torch.float64)
    sparse = torch.tensor([0.0, 2.0, 3.0, 1.0], dtype=torch.float64)
    rows = plain_rows(dense, sparse, "rrf", k=2, c=2, rrf_k=60, weight=0.5)
    # dense top-2: 0, 1; sparse top-2: 2, 1 -> doc 1 has 1/62 + 1/62
    assert rows[0][0] == 1 and math.isclose(rows[0][1], 2 / 62)
    assert rows[1][0] == 0 and math.isclose(rows[1][1], 1 / 61)
    ch = Channels(dense, sparse, sparse)
    assert band_needed(ch, rows, "rrf", 2, 2, 60, 0.5) == 0.0
    wrong = [(3, 2 / 62, 0, 0), rows[1]]          # an answer altered
    assert band_needed(ch, wrong, "rrf", 2, 2, 60, 0.5) >= 0.3
    half = [rows[0]]                              # a row left out
    assert band_needed(ch, half, "rrf", 2, 2, 60, 0.5) == NO_BAND


def test_weighted_and_near_ties():
    dense = torch.tensor([0.5, 0.5 + 1e-8, 0.2, 0.1], dtype=torch.float64)
    bm = torch.tensor([1.0, 0.0, 2.0, 0.0], dtype=torch.float64)
    rows = plain_rows(dense, bm, "weighted", k=2, c=3, rrf_k=60, weight=0.0)
    assert [r[0] for r in rows] == [1, 0]
    swapped = [(0, 0.5, 0.5, 0.5), (1, 0.5 + 1e-8, 0.5 + 1e-8, 0.0)]
    ch = Channels(dense, bm, bm)
    assert band_needed(ch, rows, "weighted", 2, 3, 60, 0.0) == 0.0
    # docs that tie within the score tolerance may trade places
    assert band_needed(ch, swapped, "weighted", 2, 3, 60, 0.0) == 0.0
    # a semantic score off by 1e-4 needs a band of that size
    off = [(1, 0.5001, 0.5001, 0.0), (0, 0.5, 0.5, 0.5)]
    assert band_needed(ch, off, "weighted", 2, 3, 60, 0.0) == 1e-4
    # rows out of their own order hold under no band
    rows3 = plain_rows(dense, bm, "weighted", k=3, c=3, rrf_k=60, weight=0.0)
    assert band_needed(ch, rows3[::-1], "weighted", 3, 3, 60, 0.0) == NO_BAND


def np_layer_norm(x, eps=1e-12):
    mu = x.mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + eps)


def test_one_layer_minilm_by_hand():
    rng = np.random.default_rng(0)
    h, inter, heads, vocab_n, l = 8, 12, 2, 20, 5

    def n(*s):
        return (0.3 * rng.standard_normal(s)).astype(np.float32)
    dense = lambda a, b: {"kernel": n(a, b), "bias": n(b)}
    ln = {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}
    p = {"embeddings": {"word": n(vocab_n, h), "position": n(16, h),
                        "token_type": n(2, h), "ln": ln},
         "layers": [{"attention": {k: dense(h, h) for k in
                                   ("query", "key", "value", "output")},
                     "attention_ln": ln, "intermediate": dense(h, inter),
                     "output": dense(inter, h), "output_ln": ln}]}
    ids = np.array([[1, 4, 7, 2, 0]])
    mask = np.array([[1, 1, 1, 1, 0]])
    got = PlainMiniLM(p, heads, "cpu").hidden(
        torch.as_tensor(ids), torch.as_tensor(mask),
        torch.zeros(1, l, dtype=torch.long)).numpy()
    e = p["embeddings"]
    x = np_layer_norm(e["word"][ids[0]] + e["position"][:l] + e["token_type"][0])
    lp = p["layers"][0]
    a = lp["attention"]
    lin = lambda x, d: x @ d["kernel"] + d["bias"]
    q, k, v = (lin(x, a[m]).reshape(l, heads, 4).transpose(1, 0, 2)
               for m in ("query", "key", "value"))
    s = q @ k.transpose(0, 2, 1) / 2.0
    s[:, :, mask[0] == 0] = -np.inf
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    ctx = (pr @ v).transpose(1, 0, 2).reshape(l, h)
    x = np_layer_norm(x + lin(ctx, a["output"]))
    f = lin(x, lp["intermediate"])
    f = 0.5 * f * (1 + np.vectorize(math.erf)(f / math.sqrt(2)))
    x = np_layer_norm(x + lin(f, lp["output"]))
    np.testing.assert_allclose(got[0], x, rtol=2e-5, atol=2e-5)


def test_encoder_and_pairs():
    vocab = build_wordpiece_vocab(DOCS * 3, size=200)
    rng = np.random.default_rng(1)
    from benchmark.data.weights import minilm_params
    enc = {"hidden": 8, "layers": 1, "intermediate": 12, "type_vocab_size": 2}
    p = minilm_params(3, "encoder", enc, len(vocab), "cpu", max_position=64)
    e = PlainEncoder(p, vocab, 2, 32, "cpu").encode(["the cat", "birds fly"])
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-6)
    ce = PlainCrossEncoder({"trunk": p, "head": {"w": rng.standard_normal(8),
                                                 "b": np.zeros(())}},
                           vocab, 2, 16, "cpu")
    ids, types = ce.pair_ids("the cat sat", "a cat and a dog " * 4)
    assert len(ids) == 16 and types[:5] == [0] * 5 and types[-1] == 1
    assert ids[0] == vocab["[CLS]"] and ids[-1] == vocab["[SEP]"]
    assert ce.scores(["x"], ["the dog"]).shape == (1,)
