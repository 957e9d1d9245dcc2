"""MiniLM (6-layer BERT) sentence encoder as a PyTorch module.

The same network as ``legal_rag_tpu.models.minilm``: post-LayerNorm
BERT (biased variance, eps 1e-12), exact erf GELU, attention written
out as matmul + softmax with an fp32 additive mask bias of -1e9 (which
would overflow in fp16), masked mean pooling and L2 normalization.
Weights come from the JAX param pytree through
:func:`legal_rag_tpu_torch.models.convert.minilm_state_dict_from_jax`;
:func:`init_minilm_params` makes that pytree from a seed with numpy.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from legal_rag_tpu_torch.config import EncoderConfig


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.output = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, l, h = x.shape
        dh = h // self.heads

        def split(t):  # [B, L, H] -> [B, heads, L, dh]
            return t.view(b, l, self.heads, dh).transpose(1, 2)

        q = split(self.query(x))
        k = split(self.key(x))
        v = split(self.value(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh) + mask_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(b, l, h)
        return self.output(ctx)


class _Layer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = _Attention(cfg.hidden, cfg.heads)
        self.attention_ln = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden, cfg.intermediate)
        self.output = nn.Linear(cfg.intermediate, cfg.hidden)
        self.output_ln = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = self.attention_ln(x + self.attention(x, mask_bias))
        inter = F.gelu(self.intermediate(x), approximate="none")
        return self.output_ln(x + self.output(inter))


class MiniLM(nn.Module):
    """BERT encoder trunk: embeddings + ``cfg.layers`` post-LN layers.
    Table sizes are explicit so they can follow the stored arrays."""

    def __init__(
        self,
        cfg: EncoderConfig,
        vocab_size: int,
        max_position: int,
        type_vocab_size: int,
    ):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(vocab_size, cfg.hidden)
        self.position = nn.Embedding(max_position, cfg.hidden)
        self.token_type = nn.Embedding(type_vocab_size, cfg.hidden)
        self.emb_ln = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.layers))

    @classmethod
    def from_state_dict(cls, cfg: EncoderConfig, sd) -> "MiniLM":
        """Build with table sizes and depth read from ``sd`` (the output
        of ``minilm_state_dict_from_jax``) and load it."""
        import dataclasses

        n_layers = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
        cfg = dataclasses.replace(
            cfg, layers=n_layers, hidden=sd["word.weight"].shape[1],
            intermediate=sd["layers.0.intermediate.weight"].shape[0],
        )
        model = cls(
            cfg,
            vocab_size=sd["word.weight"].shape[0],
            max_position=sd["position.weight"].shape[0],
            type_vocab_size=sd["token_type.weight"].shape[0],
        )
        model.load_state_dict(sd)
        return model.eval()


def minilm_hidden_states(
    model: MiniLM,
    input_ids: torch.Tensor,        # [B, L] int
    attention_mask: torch.Tensor,   # [B, L] int / float
    token_type_ids: Optional[torch.Tensor] = None,  # [B, L]; None = all 0
) -> torch.Tensor:
    """Last hidden states ``[B, L, H]`` (fp32)."""
    l = input_ids.shape[1]
    positions = torch.arange(l, device=input_ids.device)[None, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    tt = token_type_ids.clamp(0, model.token_type.num_embeddings - 1)
    x = model.word(input_ids.long()) + model.position(positions) + (
        model.token_type(tt.long())
    )
    x = model.emb_ln(x)
    # additive attention bias: 0 for real tokens, -1e9 for padding (fp32)
    mask_bias = (1.0 - attention_mask.float()) * -1e9
    mask_bias = mask_bias[:, None, None, :]     # [B, 1, 1, L]
    for layer in model.layers:
        x = layer(x, mask_bias)
    return x


def minilm_encode(
    model: MiniLM,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
) -> torch.Tensor:
    """Sentence embeddings ``[B, H]``: masked mean pool, then L2."""
    return mean_pool(
        minilm_hidden_states(model, input_ids, attention_mask), attention_mask
    )


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, H]`` hidden states -> ``[B, H]``: the mean over real
    tokens, L2-normalized."""
    mask = attention_mask.float()[:, :, None]
    pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)
    norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
    return pooled / norm.clamp(min=1e-12)


def random_minilm_params(
    rng: np.random.Generator, cfg: EncoderConfig, vocab_size: int,
    max_position: int = 512,
) -> Dict:
    """MiniLM param pytree (the JAX package's layout), N(0, 0.02)
    weights from ``rng``, zero biases, unit LayerNorm scales."""
    def normal(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros((n_out,), np.float32)}

    def ln(n):
        return {"scale": np.ones((n,), np.float32),
                "bias": np.zeros((n,), np.float32)}

    h, i = cfg.hidden, cfg.intermediate
    layers = [{
        "attention": {name: dense(h, h)
                      for name in ("query", "key", "value", "output")},
        "attention_ln": ln(h),
        "intermediate": dense(h, i),
        "output": dense(i, h),
        "output_ln": ln(h),
    } for _ in range(cfg.layers)]
    return {
        "embeddings": {
            "word": normal(vocab_size, h),
            "position": normal(max_position, h),
            "token_type": normal(cfg.type_vocab_size, h),
            "ln": ln(h),
        },
        "layers": layers,
    }


def init_minilm_params(
    cfg: EncoderConfig, seed: int = 0, max_position: int = 512
) -> Dict:
    """Deterministic random init with the distribution of the JAX
    package's ``init_minilm_params`` (normal 0.02, BERT-style), drawn by
    numpy: ``jax.random``'s numbers cannot be reproduced here, so the
    same seed gives other weights than the JAX package's."""
    return random_minilm_params(
        np.random.default_rng(seed), cfg, cfg.vocab_size, max_position
    )
