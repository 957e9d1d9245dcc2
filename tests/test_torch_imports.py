"""The PyTorch port imports without JAX: every module loads in a process
where ``jax`` and ``optax`` cannot be imported, and no source line of
the port imports them."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import legal_rag_tpu_torch

PORT_DIR = Path(legal_rag_tpu_torch.__file__).parent
REPO_ROOT = PORT_DIR.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["optax"] = None
import legal_rag_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    legal_rag_tpu_torch.__path__, "legal_rag_tpu_torch.")
    if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
print(len(names))
print(" ".join(names))
"""

# the modules of the quantized tiers, and the store module whose
# ivf_index() imports one of them lazily
QUANT_MODULES = [
    "legal_rag_tpu_torch.ops.pq",
    "legal_rag_tpu_torch.ops.pq_segmax",
    "legal_rag_tpu_torch.ops.segmax_rm",
    "legal_rag_tpu_torch.index.store",
]


def _port_modules():
    return [
        m.name for m in pkgutil.walk_packages(
            legal_rag_tpu_torch.__path__, "legal_rag_tpu_torch."
        )
        if not m.name.endswith("__main__")
    ]


def test_every_port_module_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()
    assert int(count) == len(_port_modules()) >= 20
    assert set(QUANT_MODULES) <= set(names.split())


def test_store_ivf_index_resolves_with_jax_blocked():
    """``VectorStore.ivf_index()`` imports ``ops.pq`` when called; that
    import works in a process without jax."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['optax'] = None\n"
        "import numpy as np\n"
        "from legal_rag_tpu_torch.index.store import VectorStore\n"
        "s = VectorStore(embeddings=np.zeros((3, 4), np.float32), bm25=None,\n"
        "    chunks=[], pq_codes=np.arange(6, dtype=np.uint8).reshape(3, 2),\n"
        "    ivf_centroids=np.ones((2, 4), np.float32),\n"
        "    ivf_doc_ids=np.array([2, 0, 1, -1], np.int32), ivf_cell_size=2)\n"
        "ivf = s.ivf_index()\n"
        "print(type(ivf).__module__, ivf.codes.tolist(), ivf.n_pad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "legal_rag_tpu_torch.ops.pq", "[[4,", "5],", "[0,", "1],", "[2,",
        "3],", "[0,", "0]]", "1",
    ]


def test_no_port_source_imports_jax_or_optax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax)\b", re.M)
    offenders = [
        str(p.relative_to(REPO_ROOT))
        for p in PORT_DIR.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []


def test_chip_smoke_imports_nothing_of_jax():
    """The smoke script reaches the JAX package only through the port."""
    src = (REPO_ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|optax)\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+legal_rag_tpu\b(?!_torch)", src, re.M)
