"""The port's training against the JAX package's, on the CPU.

One small MiniLM (2 layers, hidden 64, 4 heads) with weights drawn by
the JAX package and handed to both packages as numpy, over a corpus
written in-test by ``ingest.synthetic.write_legal_corpus`` (sections,
sub-sections, titles) and parsed by the port's ingest:

- ``finetune_encoder`` with the token (MaxSim) term at 0.5 and query
  augmentation on, ``train_cross_encoder_hard`` with sibling positives
  and ``train_cross_encoder``, 3 steps each from one seed: the per-step
  losses agree within 1e-4 relative (fp32 sums in another order), and
  every weight within ``2 * lr * steps + 1e-6`` (Adam's first steps
  move a weight by about lr * sign(g), and a gradient near zero can
  take either sign in either framework);
- ``adamw`` against ``optax.adamw`` on a fixed gradient sequence, and
  the warmup-cosine schedule against optax's at every step;
- the weight converters (both directions bit for bit, the HF
  converter) and the numpy init.

The ``gpu`` tests hold the same training on the card against the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legal_rag_tpu.config import EncoderConfig
from legal_rag_tpu.models import cross_encoder as jce
from legal_rag_tpu.models import finetune as jft
from legal_rag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from legal_rag_tpu.models.minilm import init_minilm_params as jax_init
from legal_rag_tpu.parallel.mesh import make_mesh
from legal_rag_tpu_torch.models import cross_encoder as tce
from legal_rag_tpu_torch.models import finetune as tft
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab,
)

CFG = EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                    intermediate=128, max_len=64, encode_batch=64)
STEPS = 3
LOSS_RTOL = 1e-4


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{path}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(t)


def _assert_weights_close(got, ref, tol):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    from legal_rag_tpu_torch.index.builder import _chunk_dicts
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    docs = tmp_path_factory.mktemp("train_docs")
    write_legal_corpus(docs, n_chunks=150, seed=5)
    return _chunk_dicts(parse_corpus(docs))


@pytest.fixture(scope="module")
def weights(chunks):
    """(vocab, cfg, the JAX init's params as numpy)."""
    vocab = build_wordpiece_vocab([c["text"] for c in chunks],
                                  size=CFG.vocab_size)
    cfg = dataclasses.replace(CFG, vocab_size=len(vocab))
    return vocab, cfg, _np_tree(jax_init(cfg, seed=3))


def _encoders(weights, device="cpu"):
    vocab, cfg, params = weights
    ref = JaxEncoder(cfg=cfg, params=params,
                     tokenizer=WordPieceTokenizer(vocab),
                     prefer_tokenizer="python")
    got = SentenceEncoder(cfg=cfg, params=params,
                          tokenizer=WordPieceTokenizer(vocab), device=device)
    return ref, got


def _port_finetune(weights, chunks, device):
    _, enc = _encoders(weights, device)
    return tft.finetune_encoder(
        enc, [c["text"] for c in chunks], steps=STEPS, chunks=chunks,
        token_maxsim_weight=0.5, augment_prob=0.5, seed=11,
    )


def test_finetune_matches_jax(weights, chunks):
    ref_enc, enc = _encoders(weights)
    texts = [c["text"] for c in chunks]
    ref, ref_losses = jft.finetune_encoder(
        ref_enc, texts, make_mesh(1), steps=STEPS, chunks=chunks,
        token_maxsim_weight=0.5, augment_prob=0.5, seed=11,
    )
    got, losses = tft.finetune_encoder(
        enc, texts, steps=STEPS, chunks=chunks,
        token_maxsim_weight=0.5, augment_prob=0.5, seed=11,
    )
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_weights_close(got.params, _np_tree(ref.params),
                          2 * 2e-5 * STEPS + 1e-6)
    # the input encoder is left as it was, as JAX's immutable params are
    _assert_weights_close(enc.params, weights[2], 0.0)
    # the tuned encoder encodes with the trained weights
    np.testing.assert_allclose(got.encode(texts[:4]), ref.encode(texts[:4]),
                               atol=1e-3)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_finetune_matches_jax_at_shards(weights, chunks, n_shards):
    """The data-parallel step at S shards (the port's one-process mesh of
    S CPU entries) against JAX's ``make_train_step`` on ``make_mesh(S)``:
    3 steps, the global batch of 30 rounded up to a multiple of S as the
    reference does, losses within 1e-4 relative."""
    from legal_rag_tpu_torch.parallel.mesh import Mesh

    ref_enc, enc = _encoders(weights)
    texts = [c["text"] for c in chunks]
    kw = dict(steps=STEPS, batch_size=30, chunks=chunks,
              token_maxsim_weight=0.5, augment_prob=0.5, seed=11)
    ref, ref_losses = jft.finetune_encoder(ref_enc, texts,
                                           make_mesh(n_shards), **kw)
    got, losses = tft.finetune_encoder(
        enc, texts, Mesh(["cpu"] * n_shards, ("shard",)), **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_weights_close(got.params, _np_tree(ref.params),
                          2 * 2e-5 * STEPS + 1e-6)


def test_sharded_step_is_the_one_device_step():
    """One step over a global batch of 8 at 1, 2 and 4 shards: the same
    loss and weights within fp32 noise (the gradient of the global mean
    loss, as JAX's shard_map step gives it)."""
    from legal_rag_tpu_torch.models.minilm import MiniLM
    from legal_rag_tpu_torch.models.train import adamw, make_train_step
    from legal_rag_tpu_torch.parallel.mesh import Mesh

    cfg = dataclasses.replace(CFG, vocab_size=300, hidden=32, layers=1,
                              intermediate=64, max_len=16)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, 300, (2, 8, 16)))
    mask = torch.from_numpy((rng.random((2, 8, 16)) < 0.8).astype(np.int64))
    mask[:, :, 0] = 1
    out = []
    for n_shards in (1, 2, 4):
        torch.manual_seed(0)
        model = MiniLM(cfg, vocab_size=300, max_position=16, type_vocab_size=2)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), 1.0),
                               maxsim_weight=0.5,
                               mesh=Mesh(["cpu"] * n_shards, ("shard",)))
        w0 = model.layers[0].intermediate.weight.detach().clone()
        loss = step(ids[0], mask[0], ids[1], mask[1])
        out.append((float(loss), w0 - model.layers[0].intermediate.weight))
    for loss, grad in out[1:]:
        assert loss == pytest.approx(out[0][0], rel=1e-6)
        torch.testing.assert_close(grad, out[0][1], rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="does not divide"):
        step(ids[0, :6], mask[0, :6], ids[1, :6], mask[1, :6])


def test_finetune_token_term_changes_the_loss(weights, chunks):
    """The MaxSim term is on: the same draws without it give another
    loss (0.0 keeps the pooled-only recipe, as in the JAX package)."""
    _, enc = _encoders(weights)
    texts = [c["text"] for c in chunks]
    _, with_tok = tft.finetune_encoder(enc, texts, steps=1, chunks=chunks,
                                       token_maxsim_weight=0.5, seed=2)
    _, pooled = tft.finetune_encoder(enc, texts, steps=1, chunks=chunks,
                                     seed=2)
    assert with_tok[0] > pooled[0]


def test_cross_encoder_hard_matches_jax(weights, chunks):
    ref_enc, enc = _encoders(weights)
    texts = [c["text"] for c in chunks]
    ref_ce = jce.CrossEncoder(ref_enc, seed=4)
    ce = tce.CrossEncoder(enc, seed=4)
    _assert_weights_close(ce.params, _np_tree(ref_ce.params), 0.0)
    ref_losses = jce.train_cross_encoder_hard(
        ref_ce, texts, chunks=chunks, steps=STEPS, sibling_prob=0.5, seed=6,
    )
    losses = tce.train_cross_encoder_hard(
        ce, texts, chunks=chunks, steps=STEPS, sibling_prob=0.5, seed=6,
    )
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_weights_close(ce.params, _np_tree(ref_ce.params),
                          2 * 5e-5 * STEPS + 1e-6)
    # the bi-encoder's weights are not the trained trunk's
    _assert_weights_close(enc.params, weights[2], 0.0)
    pairs = (["punishment for robbery"] * 2, texts[:2])
    np.testing.assert_allclose(ce.score_pairs(*pairs),
                               ref_ce.score_pairs(*pairs), atol=1e-3)


def test_cross_encoder_in_batch_matches_jax(weights, chunks):
    ref_enc, enc = _encoders(weights)
    texts = [c["text"] for c in chunks]
    ref_ce, ce = jce.CrossEncoder(ref_enc, seed=1), tce.CrossEncoder(enc, seed=1)
    ref_losses = jce.train_cross_encoder(ref_ce, texts, steps=STEPS,
                                         batch_size=4, seed=8)
    losses = tce.train_cross_encoder(ce, texts, steps=STEPS, batch_size=4,
                                     seed=8)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_weights_close(ce.params, _np_tree(ref_ce.params),
                          2 * 2e-5 * STEPS + 1e-6)


def test_sibling_prob_without_chunks_raises(weights, chunks):
    _, enc = _encoders(weights)
    with pytest.raises(ValueError, match="chunks"):
        tce.train_cross_encoder_hard(tce.CrossEncoder(enc), ["a b c"] * 3,
                                     steps=1, sibling_prob=0.5)


def test_adamw_matches_optax():
    """``models.train.adamw`` takes optax.adamw's update, decay and
    bias correction included, over a fixed gradient sequence."""
    from legal_rag_tpu_torch.models.train import adamw

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(64).astype(np.float32)
    grads = rng.standard_normal((6, 64)).astype(np.float32)
    grads[:, :8] *= 1e-6                                # near-zero gradients
    opt = optax.adamw(1e-2)
    w, state = jnp.asarray(w0), None
    state = opt.init(w)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = adamw([p], 1e-2)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("steps", [2, 3, 10, 37, 300, 4000])
def test_schedule_matches_optax_at_every_step(steps):
    """The CE schedule as train_cross_encoder_hard builds it, read at
    the update count before each update (the first at lr 0)."""
    peak = 5e-5
    kw = dict(init_value=0.0, peak_value=peak,
              warmup_steps=max(1, steps // 10), decay_steps=steps,
              end_value=peak * 0.05)
    ref = np.asarray(optax.warmup_cosine_decay_schedule(**kw)(
        jnp.arange(steps)), np.float64)
    sched = tce.warmup_cosine_decay_schedule(**kw)
    got = np.array([sched(i) for i in range(steps)])
    assert got[0] == ref[0] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_schedule_first_values():
    s = tce.warmup_cosine_decay_schedule(0.0, 5e-5, 3, 30, 5e-5 * 0.05)
    np.testing.assert_allclose([s(i) for i in range(5)],
                               [0, 5e-5 / 3, 2 * 5e-5 / 3, 5e-5, 4.9839e-5],
                               rtol=1e-4, atol=0)
    with pytest.raises(ValueError):
        tce.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 1)


def test_param_round_trip_is_bit_exact(weights, tmp_path):
    """JAX params -> the port's state dict -> JAX params, through a
    trained module's state and ``save_params_npz`` / the JAX package's
    ``load_params_npz``: every leaf bit for bit."""
    from legal_rag_tpu.models.convert import load_params_npz as jax_load
    from legal_rag_tpu_torch.models.convert import (
        minilm_params_from_state_dict, minilm_state_dict_from_jax,
        save_params_npz,
    )
    from legal_rag_tpu_torch.models.minilm import MiniLM

    _, cfg, params = weights
    model = MiniLM.from_state_dict(cfg, minilm_state_dict_from_jax(params))
    back = minilm_params_from_state_dict(model.state_dict())
    save_params_npz(back, tmp_path / "p.npz")
    for got in (back, jax_load(tmp_path / "p.npz")):
        g, r = dict(_leaves(got)), dict(_leaves(params))
        assert g.keys() == r.keys()
        for key in r:
            assert g[key].dtype == np.float32 and g[key].shape == r[key].shape
            assert g[key].tobytes() == r[key].tobytes(), key


def test_cross_encoder_params_round_trip(weights):
    _, enc = _encoders(weights)
    rng = np.random.default_rng(2)
    ckpt = {"trunk": weights[2],
            "head": {"w": rng.standard_normal(64).astype(np.float32),
                     "b": np.float32(0.25) * np.ones((), np.float32)}}
    got = tce.CrossEncoder(enc, params=ckpt).params
    _assert_weights_close(got, ckpt, 0.0)
    assert got["head"]["b"].shape == ()


def _hf_state_dict(params):
    """An HF ``BertModel`` state dict holding ``params``."""
    sd = {}

    def dense(prefix, p):
        sd[prefix + ".weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
        sd[prefix + ".bias"] = torch.from_numpy(np.array(p["bias"]))

    def ln(prefix, p):
        sd[prefix + ".weight"] = torch.from_numpy(np.array(p["scale"]))
        sd[prefix + ".bias"] = torch.from_numpy(np.array(p["bias"]))

    emb = params["embeddings"]
    sd["bert.embeddings.word_embeddings.weight"] = torch.from_numpy(np.array(emb["word"]))
    sd["bert.embeddings.position_embeddings.weight"] = torch.from_numpy(
        np.array(emb["position"]))
    sd["bert.embeddings.token_type_embeddings.weight"] = torch.from_numpy(
        np.array(emb["token_type"]))
    ln("bert.embeddings.LayerNorm", emb["ln"])
    for n, lp in enumerate(params["layers"]):
        p = f"bert.encoder.layer.{n}"
        for name in ("query", "key", "value"):
            dense(f"{p}.attention.self.{name}", lp["attention"][name])
        dense(f"{p}.attention.output.dense", lp["attention"]["output"])
        ln(f"{p}.attention.output.LayerNorm", lp["attention_ln"])
        dense(f"{p}.intermediate.dense", lp["intermediate"])
        dense(f"{p}.output.dense", lp["output"])
        ln(f"{p}.output.LayerNorm", lp["output_ln"])
    return sd


def test_convert_hf_bert_matches_jax(weights):
    from legal_rag_tpu.models.convert import convert_hf_bert as jax_convert
    from legal_rag_tpu_torch.models.convert import convert_hf_bert

    _, cfg, params = weights
    sd = _hf_state_dict(params)
    got, ref = convert_hf_bert(sd, cfg), jax_convert(sd, cfg)
    _assert_weights_close(got, ref, 0.0)
    _assert_weights_close(got, params, 0.0)


def test_numpy_init_has_the_jax_layout_and_other_numbers(weights):
    """``init_minilm_params`` draws the JAX init's shapes and
    distribution with numpy: deterministic by seed, and never the JAX
    package's numbers (the builder fingerprints the difference)."""
    from legal_rag_tpu_torch.models.minilm import init_minilm_params

    _, cfg, ref = weights
    got = init_minilm_params(cfg, seed=3)
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert g.keys() == r.keys()
    for key in r:
        assert g[key].shape == r[key].shape and g[key].dtype == np.float32
    word = g["/embeddings/word"]
    assert abs(word.std() - 0.02) < 1e-3
    assert not np.allclose(word, r["/embeddings/word"])
    again = dict(_leaves(init_minilm_params(cfg, seed=3)))
    other = dict(_leaves(init_minilm_params(cfg, seed=4)))
    assert all(np.array_equal(again[k], g[k]) for k in g)
    assert not np.array_equal(other["/embeddings/word"], word)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares training on the card "
                    "with the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_finetune_on_the_card_matches_the_cpu(cuda, weights, chunks):
    gpu, gpu_losses = _port_finetune(weights, chunks, "cuda")
    cpu, cpu_losses = _port_finetune(weights, chunks, "cpu")
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=LOSS_RTOL)
    _assert_weights_close(gpu.params, cpu.params, 2 * 2e-5 * STEPS + 1e-6)


@pytest.mark.gpu
def test_cross_encoder_hard_on_the_card_matches_the_cpu(cuda, weights, chunks):
    texts = [c["text"] for c in chunks]
    out = {}
    for device in ("cuda", "cpu"):
        ce = tce.CrossEncoder(_encoders(weights, device)[1], seed=4)
        losses = tce.train_cross_encoder_hard(
            ce, texts, chunks=chunks, steps=STEPS, sibling_prob=0.5, seed=6,
        )
        out[device] = (losses, ce.params)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=LOSS_RTOL)
    _assert_weights_close(out["cuda"][1], out["cpu"][1],
                          2 * 5e-5 * STEPS + 1e-6)
