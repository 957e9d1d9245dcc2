"""Contrastive fine-tuning of the MiniLM encoder: the loss and the step.

The port of ``legal_rag_tpu.models.train`` on one device: InfoNCE of
each query against every document of the batch (its own document is
the positive), plus, with ``maxsim_weight``, the token-level
late-interaction InfoNCE term computed from the same forward. The JAX
package runs the same loss data-parallel under ``shard_map`` and
gathers the documents of every shard; with one device the batch is the
global batch, so the loss is the same (multi-GPU is ROADMAP P13).

Gradients come from ``torch.autograd``; the optimizer is
``torch.optim.AdamW`` with optax.adamw's defaults (:func:`adamw`).
Matmuls run in full fp32, as the JAX package's ``Precision.DEFAULT`` is
on the CPU: the builder keeps TF32 off.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
import torch.nn.functional as F

from legal_rag_tpu_torch.models.minilm import (
    MiniLM, mean_pool, minilm_hidden_states,
)
from legal_rag_tpu_torch.ops.dense import l2_normalize


def adamw(params: Iterable[torch.nn.Parameter], learning_rate: float):
    """``optax.adamw(learning_rate)``'s update in torch: the same betas
    and eps, and optax's weight decay of 1e-4 (torch's default is
    1e-2). Both decay the weights decoupled, scaled by the learning
    rate, and bias-correct both moments."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4,
    )


def encode_with_tokens(
    model: MiniLM, ids: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward, two views: the L2-normalized mean-pooled sentence
    embedding ``[B, H]`` and the L2-normalized per-token hidden states
    ``[B, L, H]`` (the late-interaction representation)."""
    hidden = minilm_hidden_states(model, ids, mask)
    return mean_pool(hidden, mask), l2_normalize(hidden)


def contrastive_loss(
    model: MiniLM,
    q_ids: torch.Tensor, q_mask: torch.Tensor,
    d_ids: torch.Tensor, d_mask: torch.Tensor,
    temperature: float,
    maxsim_weight: float = 0.0,
) -> torch.Tensor:
    """InfoNCE over the batch: row i's positive is document i.

    ``maxsim_weight`` adds the token-level term: a pair's score is the
    mean over the query's real tokens of the best cosine against the
    document's real tokens, softmaxed over the batch's documents.
    ``amax`` (not ``max(dim=)``) splits the gradient among tied maxima
    as JAX's ``reduce_max`` does; a fully masked document row would
    score 0, with no NaN in its gradient.
    """
    qe, qt = encode_with_tokens(model, q_ids, q_mask)
    de, dt = encode_with_tokens(model, d_ids, d_mask)
    labels = torch.arange(qe.shape[0], device=qe.device)
    loss = F.cross_entropy(qe @ de.T / temperature, labels)
    if maxsim_weight:
        sims = torch.einsum("bth,nsh->btns", qt, dt)      # [b, Tq, N, Td]
        sims = sims.masked_fill(d_mask[None, None, :, :] == 0, -torch.inf)
        best = sims.amax(dim=3)                           # [b, Tq, N]
        best = torch.where(torch.isfinite(best), best, 0.0)
        best = best * (q_mask[:, :, None] > 0)
        n_q = (q_mask > 0).sum(dim=1).clamp(min=1)[:, None]
        ms_logits = best.sum(dim=1) / n_q / temperature
        loss = loss + maxsim_weight * F.cross_entropy(ms_logits, labels)
    return loss


def make_train_step(
    model: MiniLM,
    optimizer: torch.optim.Optimizer,
    temperature: float = 0.05,
    maxsim_weight: float = 0.0,
) -> Callable[..., torch.Tensor]:
    """``step(q_ids, q_mask, d_ids, d_mask) -> loss``: one AdamW update
    of ``model`` in place on the InfoNCE loss (the loss before the
    update, as the JAX step returns it)."""

    def step(q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = contrastive_loss(
            model, q_ids, q_mask, d_ids, d_mask, temperature, maxsim_weight,
        )
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
