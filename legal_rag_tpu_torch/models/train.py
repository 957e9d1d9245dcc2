"""Contrastive fine-tuning of the MiniLM encoder: the loss and the step.

The port of ``legal_rag_tpu.models.train``: InfoNCE of each query
against every document of the global batch (its own document is the
positive), plus, with ``maxsim_weight``, the token-level
late-interaction InfoNCE term computed from the same forward.

Data-parallel over a mesh's ``shard`` axis, as the JAX package's
``shard_map`` step: each shard encodes its slice of the global batch,
the documents' embeddings (pooled and, with ``maxsim_weight``, token
states and masks) of every shard are gathered as negatives, each
shard's labels are offset by its position, and the gradient is the
mean over shards of each shard's loss gradient, the gather
differentiated through (the JAX step transposes its ``all_gather`` and
``pmean`` s the gradients: the gradient of the global-batch mean loss,
equal to the one-device step's up to float noise). One AdamW step then
updates every replica. In one process the shards run in a loop, the
gather a concatenation that autograd reaches through to every shard's
forward; a shard on another card runs on a replica of the model, whose
gradient is added into the master's. Across processes the gather is
``torch.distributed.nn.functional.all_gather`` and the gradients are
summed with ``all_reduce``. One shard is the one-device step.

Gradients come from ``torch.autograd``; the optimizer is
``torch.optim.AdamW`` with optax.adamw's defaults (:func:`adamw`).
Matmuls run in full fp32, as the JAX package's ``Precision.DEFAULT`` is
on the CPU: the builder keeps TF32 off.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, List, Tuple

import torch
import torch.nn.functional as F

from legal_rag_tpu_torch.models.minilm import (
    MiniLM, mean_pool, minilm_hidden_states,
)
from legal_rag_tpu_torch.ops.dense import l2_normalize
from legal_rag_tpu_torch.parallel.mesh import (
    AXIS, all_reduce_sum_, positions_along,
)


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
    return _infonce(qe, qt, q_mask, de, dt, d_mask, labels, temperature,
                    maxsim_weight)


def _infonce(qe, qt, q_mask, de, dt, d_mask, labels, temperature: float,
             maxsim_weight: float) -> torch.Tensor:
    """The loss of queries ``qe [b, H]`` (tokens ``qt``) against the
    documents ``de [N, H]`` (tokens ``dt``, mask ``d_mask``), query i's
    positive at ``labels[i]``."""
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
    mesh=None,
) -> Callable[..., torch.Tensor]:
    """``step(q_ids, q_mask, d_ids, d_mask) -> loss``: one AdamW update
    of ``model`` in place on the InfoNCE loss (the loss before the
    update, as the JAX step returns it). With a ``mesh`` of more than
    one shard (or one built across processes), the step is
    data-parallel over its ``shard`` axis (module note) and the global
    batch must divide by the shard count."""
    if mesh is not None and (mesh.shape[AXIS] > 1 or mesh.multi_process):
        return _sharded_step(model, optimizer, temperature, maxsim_weight,
                             mesh)

    def step(q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = contrastive_loss(
            model, q_ids, q_mask, d_ids, d_mask, temperature, maxsim_weight,
        )
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _gather_rows(parts: List[torch.Tensor], mesh, dev) -> torch.Tensor:
    """The shards' rows side by side on ``dev``: ``parts`` are this
    process's shards' in shard order; across processes they meet in one
    differentiable all_gather (on the host under gloo), rank-major,
    which is shard order for a mesh of :func:`make_mesh`."""
    mine = torch.cat([p.to(dev) for p in parts])
    if not mesh.multi_process:
        return mine
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_nn

    if dist.get_backend() == "gloo":
        mine = mine.cpu()
    if mine.requires_grad:
        everyone = dist_nn.all_gather(mine)
    else:
        everyone = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(everyone, mine)
    return torch.cat([t.to(dev) for t in everyone])


def _gather_docs(enc, mesh, dev, tokens: bool):
    """Every shard's document embeddings on ``dev``: pooled ``[S*b, H]``
    and, with ``tokens``, token states ``[S*b, L, H]`` and masks. The
    pooled and token rows travel as one tensor, so the backward runs one
    collective (one order on every process)."""
    de = [e[5] for e in enc]
    if not tokens:
        return _gather_rows(de, mesh, dev), None, None
    rows, h = de[0].shape
    dt = [e[6] for e in enc]
    both = _gather_rows(
        [torch.cat([a, b.reshape(rows, -1)], dim=1) for a, b in zip(de, dt)],
        mesh, dev)
    all_dt = both[:, h:].reshape(both.shape[0], *dt[0].shape[1:])
    return both[:, :h], all_dt, _gather_rows([e[7] for e in enc], mesh, dev)


def _sharded_step(model: MiniLM, optimizer, temperature: float,
                  maxsim_weight: float, mesh) -> Callable[..., torch.Tensor]:
    shards = positions_along(mesh, AXIS)
    n_shards = len(shards)
    local = [(s, mesh.devices[pos]) for s, pos in enumerate(shards)
             if mesh.is_local(pos)]
    master = next(model.parameters()).device
    replicas = {dev: copy.deepcopy(model).to(dev)
                for _, dev in local if dev != master}

    def module_on(dev) -> MiniLM:
        return model if dev == master else replicas[dev]

    def step(q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        if q_ids.shape[0] % n_shards:
            raise ValueError(f"batch {q_ids.shape[0]} does not divide over "
                             f"{n_shards} shards")
        b = q_ids.shape[0] // n_shards
        optimizer.zero_grad(set_to_none=True)
        for rep in replicas.values():
            rep.zero_grad(set_to_none=True)
        enc = []
        for s, dev in local:
            rows = slice(s * b, (s + 1) * b)
            m = module_on(dev)
            qm, dm = q_mask[rows].to(dev), d_mask[rows].to(dev)
            qe, qt = encode_with_tokens(m, q_ids[rows].to(dev), qm)
            de, dt = encode_with_tokens(m, d_ids[rows].to(dev), dm)
            enc.append((s, dev, qe, qt, qm, de, dt, dm))
        gathered = {}
        total = None
        for s, dev, qe, qt, qm, _, _, _ in enc:
            if dev not in gathered:
                gathered[dev] = _gather_docs(enc, mesh, dev,
                                             bool(maxsim_weight))
            all_de, all_dt, all_dm = gathered[dev]
            labels = s * b + torch.arange(b, device=dev)
            loss = _infonce(qe, qt, qm, all_de, all_dt, all_dm, labels,
                            temperature, maxsim_weight).to(master)
            total = loss if total is None else total + loss
        (total / n_shards).backward()
        params = [p for p in model.parameters()]
        for rep in replicas.values():
            for p, r in zip(params, rep.parameters()):
                if r.grad is not None:
                    g = r.grad.to(master)
                    p.grad = g if p.grad is None else p.grad + g
        loss = total.detach() / n_shards
        if mesh.multi_process:
            all_reduce_sum_([p.grad for p in params if p.grad is not None]
                            + [loss])
        optimizer.step()
        with torch.no_grad():
            for rep in replicas.values():
                for p, r in zip(params, rep.parameters()):
                    r.copy_(p)
        return loss

    return step
