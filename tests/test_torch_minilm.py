"""MiniLM, the sentence encoder and the cross-encoder: the port against
the JAX package on the same numpy-seeded weights and inputs.

Tolerance: per-row cosine >= 0.9999 and atol 1e-5 on unit-norm
embeddings (the bar tests/test_minilm.py sets against torch BertModel):
both sides compute in fp32 (JAX at Precision.HIGHEST), so only the
summation order differs. CE logits: atol 1e-5 (scores ~1e-2 here).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from legal_rag_tpu.config import EncoderConfig
from legal_rag_tpu.models.minilm import minilm_encode as jax_minilm_encode
from legal_rag_tpu.models.cross_encoder import (
    cross_encode_scores as jax_cross_encode_scores,
)
from legal_rag_tpu.models import convert as jax_convert
from legal_rag_tpu_torch.index.synthetic import random_minilm_params
from legal_rag_tpu_torch.models import convert
from legal_rag_tpu_torch.models.minilm import MiniLM, minilm_encode
from legal_rag_tpu_torch.models.cross_encoder import cross_encode_scores

CFG = EncoderConfig(
    vocab_size=120, hidden=64, layers=2, heads=4, intermediate=128,
    max_len=32,
)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(11)
    p = random_minilm_params(rng, CFG, vocab_size=120, max_position=64)
    # non-trivial biases and LayerNorm affine terms, so a swapped or
    # untransposed tensor cannot pass
    for layer in p["layers"]:
        for node in (layer["attention"]["query"], layer["intermediate"],
                     layer["output"]):
            node["bias"] = (0.1 * rng.standard_normal(node["bias"].shape)
                            ).astype(np.float32)
        layer["output_ln"]["scale"] = (
            1 + 0.1 * rng.standard_normal(CFG.hidden)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(12)
    b, l = 6, 24
    ids = rng.integers(5, 120, (b, l)).astype(np.int32)
    lens = np.array([24, 20, 9, 3, 1, 16])
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 0).astype(np.int32)
    tt = ((np.arange(l)[None, :] >= lens[:, None] // 2) & (mask == 1)).astype(
        np.int32)
    return ids, mask, tt


def _model(params):
    return MiniLM.from_state_dict(CFG, convert.minilm_state_dict_from_jax(params))


def _assert_embeddings_close(got, ref):
    cos = np.sum(got * ref, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert (cos >= 0.9999).all(), cos
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_minilm_encode_matches_jax(params, batch):
    ids, mask, _ = batch
    ref = np.asarray(jax_minilm_encode(
        params, jnp.asarray(ids), jnp.asarray(mask), CFG))
    with torch.inference_mode():
        got = minilm_encode(
            _model(params), torch.from_numpy(ids), torch.from_numpy(mask)
        ).numpy()
    _assert_embeddings_close(got, ref)


def test_cross_encode_scores_match_jax(params, batch):
    ids, mask, tt = batch
    rng = np.random.default_rng(13)
    head = {"w": (0.5 * rng.standard_normal(CFG.hidden)).astype(np.float32),
            "b": np.float32(0.25)}
    ref = np.asarray(jax_cross_encode_scores(
        {"trunk": params, "head": head}, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(tt), CFG))
    with torch.inference_mode():
        got = cross_encode_scores(
            _model(params), torch.from_numpy(head["w"]),
            torch.tensor(head["b"]), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(tt),
        ).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_state_dict_conversion_layout(params):
    sd = convert.minilm_state_dict_from_jax(params)
    q = params["layers"][1]["attention"]["query"]
    np.testing.assert_array_equal(
        sd["layers.1.attention.query.weight"].numpy(), q["kernel"].T)
    np.testing.assert_array_equal(
        sd["layers.0.output_ln.weight"].numpy(),
        params["layers"][0]["output_ln"]["scale"])
    # tables are sized from the arrays, not from EncoderConfig
    model = _model(params)
    assert model.word.num_embeddings == 120
    assert model.position.num_embeddings == 64
    assert len(model.layers) == 2


def test_npz_round_trip_between_packages(params, tmp_path):
    convert.save_params_npz(params, tmp_path / "port.npz")
    back = jax_convert.load_params_npz(tmp_path / "port.npz")
    jax_convert.save_params_npz(params, tmp_path / "jax.npz")
    again = convert.load_params_npz(tmp_path / "jax.npz")
    for loaded in (back, again):
        sd_a = convert.minilm_state_dict_from_jax(loaded)
        sd_b = convert.minilm_state_dict_from_jax(params)
        assert sd_a.keys() == sd_b.keys()
        for key in sd_a:
            assert torch.equal(sd_a[key], sd_b[key]), key


def test_sentence_encoder_matches_jax(params):
    from legal_rag_tpu.models.encoder import SentenceEncoder as JaxEncoder
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.wordpiece import (
        WordPieceTokenizer, build_wordpiece_vocab,
    )

    texts = ["punishment for robbery", "zero fir registration procedure",
             "victim compensation under the nalsa scheme for acid attack",
             "bail", "what are the rights of the accused during arrest?"]
    vocab = build_wordpiece_vocab(texts * 3, size=120)
    p = dict(params)
    cfg = dataclasses.replace(CFG, vocab_size=len(vocab), encode_batch=2)
    p["embeddings"] = dict(params["embeddings"],
                           word=params["embeddings"]["word"][: len(vocab)])
    ref = JaxEncoder(cfg=cfg, params=p, tokenizer=WordPieceTokenizer(vocab),
                     prefer_tokenizer="python").encode(texts)
    got = SentenceEncoder(cfg=cfg, params=p, device="cpu",
                          tokenizer=WordPieceTokenizer(vocab)).encode(texts)
    _assert_embeddings_close(got, ref)


def test_sentence_encoder_requires_weights():
    """Without ``params`` the encoder makes its weights: the numpy init
    of its seed (the JAX package's random init draws other numbers),
    with the word table sized to the vocab built from ``vocab_corpus``."""
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.models.minilm import init_minilm_params

    texts = ["punishment for robbery", "zero fir registration procedure"]
    enc = SentenceEncoder(cfg=CFG, vocab_corpus=texts, seed=5, device="cpu")
    assert enc.tokenizer_impl == "python"
    assert enc.cfg.vocab_size == len(enc.tokenizer.vocab)
    ref = init_minilm_params(enc.cfg, seed=5)
    assert np.array_equal(enc.params["embeddings"]["word"],
                          ref["embeddings"]["word"])
    again = SentenceEncoder(cfg=CFG, vocab_corpus=texts, seed=5, device="cpu")
    np.testing.assert_array_equal(enc.encode(texts), again.encode(texts))