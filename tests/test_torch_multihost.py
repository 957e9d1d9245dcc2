"""The port's sharded search and data-parallel step across two OS
processes (tests/test_multihost.py on the port).

Two processes join a gloo process group on the CPU through
``initialize_distributed``, two mesh entries each, so ``make_mesh(4)``
spans the process boundary. Each process places the same host arrays
with ``ShardedIndex.from_embeddings`` (``device_put_global``: it keeps
only its two shards' rows) and ``replicate_global``, runs
``sharded_hybrid_search`` (weighted over scatter BM25, RRF over segment
sums; the collectives are ``dist.all_gather`` and ``dist.all_reduce``),
and one data-parallel fine-tune step over the global batch of 8. Both
processes must return the JAX package's single-process S=4 results,
computed here, and the step's loss and weights must equal the port's
one-process S=4 step within 1e-5 relative (fp32 sums in another order).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300

COMMON = r"""
import numpy as np
import torch

N, D, Q = 96, 16, 4


def inputs():
    rng = np.random.default_rng(0)            # identical on every process
    docs = rng.standard_normal((N, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q_emb = rng.standard_normal((Q, D)).astype(np.float32)
    post_ids = rng.integers(0, N, (Q, 16)).astype(np.int32)
    post_w = rng.random((Q, 16)).astype(np.float32)
    weights = np.full((Q,), 0.5, dtype=np.float32)
    return docs, post_ids, post_w, q_emb, weights


def train_step(mesh):
    from legal_rag_tpu_torch.config import EncoderConfig
    from legal_rag_tpu_torch.models.minilm import MiniLM
    from legal_rag_tpu_torch.models.train import adamw, make_train_step

    cfg = EncoderConfig(vocab_size=300, hidden=32, layers=1, heads=4,
                        intermediate=64, max_len=16)
    torch.manual_seed(0)
    model = MiniLM(cfg, vocab_size=300, max_position=16, type_vocab_size=2)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, 300, (2, 8, 16)))
    mask = torch.from_numpy((rng.random((2, 8, 16)) < 0.8).astype(np.int64))
    mask[:, :, 0] = 1
    step = make_train_step(model, adamw(model.parameters(), 1e-3),
                           maxsim_weight=0.5, mesh=mesh)
    loss = float(step(ids[0], mask[0], ids[1], mask[1]))
    return loss, model.layers[0].intermediate.weight.detach().numpy().copy()
"""

WORKER = r"""
import json
import os
import sys

sys.path.insert(0, os.environ["LR_REPO"])

from legal_rag_tpu_torch.parallel.mesh import (
    device_put_global, initialize_distributed, make_mesh, replicate_global,
    shutdown_distributed,
)

initialize_distributed(
    coordinator_address=os.environ["LR_COORD"], num_processes=2,
    process_id=int(os.environ["LR_PID"]), local_device_ids=[0, 1],
    device="cpu",
)
""" + COMMON + r"""
from legal_rag_tpu_torch.parallel.sharded import (
    ShardedIndex, sharded_hybrid_search,
)

assert "jax" not in sys.modules
mesh = make_mesh(4, device="cpu")             # global: spans both processes
assert mesh.multi_process and len(mesh.local_positions()) == 2
docs, post_ids, post_w, q_emb, weights = inputs()
pid = int(os.environ["LR_PID"])
g = device_put_global(docs, mesh, ("shard", None))
assert sorted(g.blocks) == [(2 * pid,), (2 * pid + 1,)]
for (s,), t in g.blocks.items():
    assert np.array_equal(t.numpy(), docs[s * 24:(s + 1) * 24])
index = ShardedIndex.from_embeddings(docs, mesh)
out = {"process": pid}
for mode, sparse in (("weighted", "scatter"), ("rrf", "segsum")):
    scores, ids, _, _ = sharded_hybrid_search(
        index.docs,
        replicate_global(post_ids, mesh), replicate_global(post_w, mesh),
        replicate_global(q_emb, mesh), replicate_global(weights, mesh),
        mesh=mesh, k=5, c=10, n_docs=N, mode=mode, sparse_mode=sparse,
    )
    out[mode] = {"ids": ids.tolist(), "scores": scores.tolist()}
loss, w = train_step(mesh)
out["loss"] = loss
np.save(os.environ["LR_OUT"], w)
shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_search_and_step_across_two_processes(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["LR_REPO"] = str(REPO)
        env["LR_COORD"] = f"localhost:{port}"
        env["LR_PID"] = str(pid)
        env["LR_OUT"] = str(tmp_path / f"w{pid}.npy")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out
        results.append(json.loads(lines[-1][len("RESULT "):]))
    assert [r["process"] for r in results] == [0, 1]

    import jax.numpy as jnp
    from legal_rag_tpu.parallel.mesh import make_mesh
    from legal_rag_tpu.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    scope = {}
    exec(COMMON, scope)
    docs, post_ids, post_w, q_emb, weights = scope["inputs"]()
    mesh = make_mesh(4)
    index = ShardedIndex.from_embeddings(docs, mesh)
    for mode, sparse in (("weighted", "scatter"), ("rrf", "segsum")):
        gold_s, gold_i, _, _ = sharded_hybrid_search(
            index.docs, jnp.asarray(post_ids), jnp.asarray(post_w),
            jnp.asarray(q_emb), jnp.asarray(weights),
            mesh=mesh, k=5, c=10, n_docs=scope["N"], mode=mode,
            sparse_mode=sparse,
        )
        for r in results:
            assert r[mode]["ids"] == np.asarray(gold_i).tolist()
            np.testing.assert_allclose(r[mode]["scores"], np.asarray(gold_s),
                                       rtol=0, atol=1e-5)

    # the two processes' step equals the one-process 4-shard step
    from legal_rag_tpu_torch.parallel.mesh import Mesh

    loss, w = scope["train_step"](Mesh(["cpu"] * 4, ("shard",)))
    for pid, r in enumerate(results):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(np.load(tmp_path / f"w{pid}.npy"), w,
                                   rtol=0, atol=1e-5)
