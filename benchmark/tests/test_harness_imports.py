"""What the benchmark may import, by whole top-level module names:
nothing of JAX or the JAX package anywhere (``legal_rag_tpu_torch``
begins with ``legal_rag_tpu`` but is the port), and nothing of the port
in the plain reference."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "legal_rag_tpu"}


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (top_names(path) & JAX), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_names(path)
    assert "legal_rag_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "dataclasses", "math", "re",
                     "typing", "unicodedata", "collections", "numpy", "torch",
                     "benchmark"}, names


def test_whole_names_are_compared():
    src = "import legal_rag_tpu_torch.config\nfrom legal_rag_tpu import x\n"
    p = BENCH / "tests" / "_probe_names.py"
    try:
        p.write_text(src)
        assert top_names(p) == {"legal_rag_tpu_torch", "legal_rag_tpu"}
    finally:
        p.unlink()


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "legal_rag_tpu_torch_probe",
                        types.ModuleType("x"))
    assert "legal_rag_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in run.forbidden_modules()
