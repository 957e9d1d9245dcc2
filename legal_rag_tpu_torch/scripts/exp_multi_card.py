"""The sharded paths across several cards, each against the same work on
one card.

Over N random unit rows (default 2^21, so each of 4 shards holds 524,288
rows and K1 runs once a shard), 64 queries near docs and random
postings:

1. one process: ``sharded_hybrid_search`` (RRF and weighted) at S=1 on
   the first card, at S on that card (every mesh position on it) and at
   S over S cards (``make_mesh(S)``): ids equal, scores within 1e-5;
   each search's ms and the candidates' gather alone;
2. one process: three data-parallel fine-tune steps (MiniLM at full
   width, seeded random weights, the token term on, global batch 32) at
   S on the first card and at S over S cards: losses within 1e-4
   relative; ms a step;
3. S processes, one card each, over NCCL (``initialize_distributed``):
   the same searches and steps, equal to 1 and 2, with their ms.

Times are CUDA events on the first card's stream (searches, gathers)
and the host clock around synchronized steps. ``--device cpu``
rehearses the paths without a card (S CPU mesh entries in one process,
S gloo processes); it reports no time. One JSON line a measurement;
exits non-zero when a check fails.

Run on a machine with S cards:
  python -m legal_rag_tpu_torch.scripts.exp_multi_card [--shards 4] [--n N]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

D, Q, P, K, C = 384, 64, 256, 10, 20
STEPS, BATCH, SEQ = 3, 32, 64
SCORE_TOL, LOSS_RTOL = 1e-5, 1e-4
MODES = ("rrf", "weighted")


def make_inputs(n: int, seed: int = 0):
    """``(docs [n, D], q [Q, D], post ids [Q, P], post weights [Q, P],
    hybrid weights [Q])``: unit rows, queries a doc plus noise."""
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n, D), dtype=np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[rng.integers(0, n, Q)] + 0.1 * rng.standard_normal(
        (Q, D), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pid = rng.integers(0, n, (Q, P)).astype(np.int32)
    pw = rng.gamma(2.0, 1.0, (Q, P)).astype(np.float32)
    return docs, q, pid, pw, np.full(Q, 0.5, np.float32)


def train_batches(vocab: int, seed: int = 1):
    """``[STEPS, 4, BATCH, SEQ]``: query ids, mask, doc ids, mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (STEPS, 2, BATCH, SEQ))
    lens = rng.integers(4, SEQ + 1, (STEPS, 2, BATCH))
    mask = (np.arange(SEQ) < lens[..., None]).astype(np.int64)
    return torch.from_numpy(np.stack(
        [ids[:, 0], mask[:, 0], ids[:, 1], mask[:, 1]], axis=1))


def timed(fn, on_card: bool):
    """CUDA-event ms a call on the current card (None off a card)."""
    if not on_card:
        fn()
        return None
    from legal_rag_tpu_torch.utils.timing import time_ms

    return time_ms(fn, iters=10, warmup=2)


def search(index, args, mesh, mode):
    from legal_rag_tpu_torch.parallel.sharded import sharded_hybrid_search

    return sharded_hybrid_search(index.docs, *args, mesh=mesh, k=K, c=C,
                                 n_docs=index.n_docs, mode=mode)


def run_searches(docs, args, mesh, on_card: bool) -> dict:
    """The index on ``mesh``, both modes' results and ms, the gather's."""
    from legal_rag_tpu_torch.ops.segmax_rm import K1
    from legal_rag_tpu_torch.parallel.sharded import ShardedIndex, _Work

    index = ShardedIndex.from_embeddings(docs, mesh)
    out = {}
    for mode in MODES:
        K1.launches = 0
        f, i, _, _ = search(index, args, mesh, mode)
        out[mode] = (f.cpu().numpy(), i.cpu().numpy(), K1.launches)
        out[mode + "_ms"] = timed(lambda: search(index, args, mesh, mode),
                                  on_card)
    work = _Work(mesh, None, Q)
    items = {key: torch.zeros(Q, C, device=work.device(pos))
             for key, pos in work.local}
    out["gather_ms"] = timed(lambda: work.to_qc(work.gather(items), 0),
                             on_card)
    return out


def run_steps(mesh, device, on_card: bool):
    """Three fine-tune steps of a seeded MiniLM on ``mesh``: the losses
    and the ms of each step after the first."""
    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.models.minilm import MiniLM
    from legal_rag_tpu_torch.models.train import adamw, make_train_step

    cfg = EncoderConfig()
    torch.manual_seed(0)
    model = MiniLM(cfg, vocab_size=cfg.vocab_size, max_position=512,
                   type_vocab_size=cfg.type_vocab_size).to(device)
    step = make_train_step(model, adamw(model.parameters(), 2e-5),
                           maxsim_weight=0.5, mesh=mesh)
    losses, ms = [], []
    for b in train_batches(cfg.vocab_size):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(*(x.to(device) for x in b))))
        if on_card:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, (ms[1:] if on_card else None)


def check_same(got, ref, what: str) -> None:
    for mode in MODES:
        (f, i, _), (rf, ri, _) = got[mode], ref[mode]
        if not np.array_equal(i, ri):
            raise AssertionError(f"{what} {mode}: ids differ")
        gap = float(np.abs(f - rf).max())
        if gap > SCORE_TOL:
            raise AssertionError(f"{what} {mode}: scores differ by {gap}")


def check_losses(got, ref, what: str) -> None:
    rel = float(np.max(np.abs(np.subtract(got, ref)) / np.abs(ref)))
    if rel > LOSS_RTOL:
        raise AssertionError(f"{what}: losses {got} vs {ref}")


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def worker(args) -> None:
    """One of S processes: its card (or a CPU entry under gloo), the
    global mesh, the searches and steps; results to ``LR_OUT``."""
    from legal_rag_tpu_torch.parallel import mesh as pm

    rank, world = int(os.environ["LR_RANK"]), args.shards
    on_card = args.device == "cuda"
    pm.initialize_distributed(os.environ["LR_COORD"], world, rank,
                              [rank] if on_card else [0], device=args.device)
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    docs = np.load(os.environ["LR_DOCS"], mmap_mode="r")
    inp = np.load(os.environ["LR_INPUTS"])
    sargs = [torch.from_numpy(inp[k]).to(dev) for k in ("pid", "pw", "q", "w")]
    mesh = pm.make_mesh(world, device=args.device)
    res = run_searches(docs, sargs, mesh, on_card)
    losses, step_ms = run_steps(mesh, dev, on_card)
    np.savez(os.environ["LR_OUT"], **{
        f"{m}_{j}": res[m][j] for m in MODES for j in (0, 1)},
        losses=np.asarray(losses))
    emit(part="process", rank=rank, world=world, backend=pm._WORLD.backend,
         k1=[res[m][2] for m in MODES],
         **{f"{m}_ms": res[m + "_ms"] for m in MODES},
         gather_ms=res["gather_ms"], step_ms=step_ms)
    pm.shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(n: int, shards: int, device: str = "cuda", seed: int = 0,
        work_dir: str = "build/exp_multi_card") -> dict:
    from legal_rag_tpu_torch.ops.dense import TWOPHASE_MIN_DOCS
    from legal_rag_tpu_torch.parallel.mesh import Mesh, make_mesh

    on_card = device == "cuda"
    if on_card and torch.cuda.device_count() < shards:
        raise SystemExit(f"exp_multi_card: {shards} shards need {shards} "
                         f"cards, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    first = torch.device("cuda", 0) if on_card else torch.device("cpu")
    docs, q, pid, pw, w = make_inputs(n, seed)
    args = [torch.from_numpy(a).to(first) for a in (pid, pw, q, w)]
    meshes = {
        "S=1": Mesh([first], ("shard",)),
        f"S={shards} one card": Mesh([first] * shards, ("shard",)),
        f"S={shards} over {shards} cards": (
            make_mesh(shards) if on_card
            else Mesh(["cpu"] * shards, ("shard",))),
    }
    res = {}
    for name, mesh in meshes.items():
        res[name] = run_searches(docs, args, mesh, on_card)
        emit(part="search", mesh=name, device=device,
             k1=[res[name][m][2] for m in MODES],
             **{f"{m}_ms": res[name][m + "_ms"] for m in MODES},
             gather_ms=res[name]["gather_ms"])
        if on_card:
            torch.cuda.empty_cache()
    names = list(meshes)
    for name in names[1:]:
        k1 = [res[name][m][2] for m in MODES]
        if on_card and n // shards >= TWOPHASE_MIN_DOCS and k1 != [shards] * 2:
            raise AssertionError(f"{name}: K1 launched {k1}, not once a shard")
    check_same(res[names[1]], res[names[0]], names[1])
    check_same(res[names[2]], res[names[0]], names[2])
    losses = {}
    for name in names[1:]:
        losses[name], step_ms = run_steps(meshes[name], first, on_card)
        emit(part="steps", mesh=name, losses=losses[name], step_ms=step_ms)
    check_losses(losses[names[2]], losses[names[1]], names[2])

    # S processes, one card each
    os.makedirs(work_dir, exist_ok=True)
    docs_path = os.path.join(work_dir, "docs.npy")
    in_path = os.path.join(work_dir, "inputs.npz")
    np.save(docs_path, docs)
    np.savez(in_path, pid=pid, pw=pw, q=q, w=w)
    del docs
    port = _free_port()
    procs = []
    for rank in range(shards):
        env = dict(os.environ, LR_RANK=str(rank), LR_COORD=f"localhost:{port}",
                   LR_DOCS=docs_path, LR_INPUTS=in_path,
                   LR_OUT=os.path.join(work_dir, f"rank{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "legal_rag_tpu_torch.scripts.exp_multi_card",
             "--worker", "--shards", str(shards), "--device", device,
             "--seed", str(seed)], env=env))
    try:
        for p in procs:
            if p.wait(timeout=900) != 0:
                raise AssertionError(f"a process exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank in range(shards):
        got = np.load(os.path.join(work_dir, f"rank{rank}.npz"))
        check_same({m: (got[f"{m}_0"], got[f"{m}_1"], 0) for m in MODES},
                   res[names[0]], f"process {rank}")
        check_losses(list(got["losses"]), losses[names[1]],
                     f"process {rank}")
    emit(part="ok", shards=shards, n=n, device=device,
         card=torch.cuda.get_device_name(0) if on_card else None)
    return {"searches": res, "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_multi_card: no CUDA card (use --device cpu "
                         "for a rehearsal)")
    run(args.n, args.shards, args.device, args.seed)


if __name__ == "__main__":
    main()
