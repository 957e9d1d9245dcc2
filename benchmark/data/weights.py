"""Seeded weights and embeddings, drawn on the device in a few calls.

Every draw takes its own generator, seeded from the run's seed and the
draw's name, so adding a draw never moves another. The MiniLM weights
follow BERT's initialisation (N(0, 0.02) matrices and tables, zero
biases, unit LayerNorm scales) in the JAX package's pytree layout, which
the program and the reference both read; the program is handed float32
numpy arrays, as a store's ``encoder.npz`` gives them.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named draw of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def minilm_params(seed: int, name: str, enc: Dict, vocab_size: int,
                  device, max_position: int = 512) -> Dict:
    """A MiniLM trunk at the configuration's widths (``enc``: hidden,
    layers, intermediate, type_vocab_size): all matrices from one draw."""
    h, i, n_layers = enc["hidden"], enc["intermediate"], enc["layers"]
    shapes = [(vocab_size, h), (max_position, h), (enc["type_vocab_size"], h)]
    for _ in range(n_layers):
        shapes += [(h, h)] * 4 + [(h, i), (i, h)]
    total = sum(a * b for a, b in shapes)
    flat = 0.02 * torch.randn(total, generator=generator(seed, name, device),
                              device=device, dtype=torch.float32)
    flat = flat.cpu().numpy()
    mats, off = [], 0
    for a, b in shapes:
        mats.append(flat[off:off + a * b].reshape(a, b))
        off += a * b

    def dense(kernel):
        return {"kernel": kernel,
                "bias": np.zeros((kernel.shape[1],), np.float32)}

    def ln():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    layers, it = [], iter(mats[3:])
    for _ in range(n_layers):
        att = {n: dense(next(it)) for n in ("query", "key", "value", "output")}
        layers.append({"attention": att, "attention_ln": ln(),
                       "intermediate": dense(next(it)),
                       "output": dense(next(it)), "output_ln": ln()})
    return {"embeddings": {"word": mats[0], "position": mats[1],
                           "token_type": mats[2], "ln": ln()},
            "layers": layers}


def cross_encoder_params(seed: int, enc: Dict, vocab_size: int,
                         device) -> Dict:
    """A cross-encoder: its own trunk and a linear head, N(0, 0.02)."""
    head = 0.02 * torch.randn(enc["hidden"],
                              generator=generator(seed, "ce_head", device),
                              device=device)
    return {"trunk": minilm_params(seed, "ce_trunk", enc, vocab_size, device),
            "head": {"w": head.cpu().numpy(), "b": np.zeros((), np.float32)}}


def unit_embeddings(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """``[n, dim]`` float32 unit rows on ``device``."""
    e = torch.randn((n, dim), generator=generator(seed, "doc_embeddings",
                                                  device), device=device)
    return e / e.norm(dim=1, keepdim=True)
