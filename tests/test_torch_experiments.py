"""The port's timing experiments against the JAX package's: the kernel
bodies the JAX scripts launch, run in Pallas interpret mode, against the
plain versions of the port's kernels; the two-level segment select; and
each experiment script of the port run end to end on the CPU.

The scripts' nested kernel bodies cannot be imported without running
their ``main()`` (and importing a script turns on a compile cache), so
each body's source is read out of the script with ``ast`` and executed
unchanged. Data passes between the packages as numpy arrays made from a
seed. Tolerances: the stream probe's block maxima are exact (equal) and
its in-order sum within 1e-6 relative; the products are fp32 sums of
exact bf16 products taken in another order, within 1e-5. The GPU cases
at the end hold kernels X1, X2 and K4 (seg_rows 32) against their plain
versions on the card.
"""

import ast
import functools
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import legal_rag_tpu.ops.dense as jdense
import legal_rag_tpu_torch.ops.dense as tdense
from legal_rag_tpu_torch.ops import mm_rowmax as x2
from legal_rag_tpu_torch.ops import segmax_cm as k4
from legal_rag_tpu_torch.ops import segmax_rm as k1
from legal_rag_tpu_torch.ops import stream_probe as x1

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TOL = 1e-5
SCRIPT_NAMES = ["exp_dense_roofline", "exp_twophase_stages",
                "exp_twophase_rowmajor", "exp_rm_stages",
                "exp_select_variants", "exp_member_topk"]


def script_defs(script: str, *names: str) -> dict:
    """Execute the named definitions (functions, nested or not, and
    module-level assignments) of ``scripts/<script>`` unchanged."""
    src = (SCRIPTS / script).read_text()
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl}
    for node in ast.walk(ast.parse(src)):
        name = (node.name if isinstance(node, ast.FunctionDef) else
                node.targets[0].id if isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name) else None)
        if name in names and name not in ns:
            exec(textwrap.dedent(ast.get_source_segment(src, node)), ns)
    missing = set(names) - set(ns)
    assert not missing, f"{script} lacks {missing}"
    return ns


def bf16(rng, *shape, unit_axis=None):
    """Seeded normal values rounded to bf16, as float32 numpy."""
    x = rng.standard_normal(shape).astype(np.float32)
    if unit_axis is not None:
        x /= np.linalg.norm(x, axis=unit_axis, keepdims=True)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch_bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def padded_docs_t(rng, d, n, bn):
    """``[d, n]`` unit columns zero-padded to a multiple of ``bn``, as the
    JAX script pads ``dt16``."""
    n_pad = -(-n // bn) * bn
    out = np.zeros((d, n_pad), np.float32)
    out[:, :n] = bf16(rng, d, n, unit_axis=0)
    return out


# -- X1: stream_kernel against the port's stream probe -------------------


@pytest.mark.parametrize("d,bn,n", [(16, 128, 300), (384, 1024, 2500),
                                    (64, 512, 1537)])
def test_stream_kernel_matches_port(d, bn, n):
    stream_kernel = script_defs("exp_dense_roofline.py", "stream_kernel")[
        "stream_kernel"]
    dpad = padded_docs_t(np.random.default_rng(d + n), d, n, bn)
    nb = dpad.shape[1] // bn

    def launch(x):
        return pl.pallas_call(
            stream_kernel,
            grid=(x.shape[1] // bn,),
            in_specs=[pl.BlockSpec((d, bn), lambda j: (0, j))],
            out_specs=pl.BlockSpec((1, 1), lambda j: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
            interpret=True,
        )(jnp.asarray(x, jnp.bfloat16))[0, 0]

    want_total = float(launch(dpad))
    want_max = [float(launch(dpad[:, j * bn:(j + 1) * bn])) for j in range(nb)]
    got_max, got_total = x1.stream_probe(to_torch_bf16(dpad), bn)
    assert got_max.dtype == torch.float32 and got_max.shape == (nb,)
    assert got_max.tolist() == want_max
    assert abs(float(got_total) - want_total) <= 1e-6 * abs(want_total)


# -- X2: mm_kernel against the port's matmul probe -----------------------


@pytest.mark.parametrize("q,d,bn,n", [(8, 64, 128, 300), (64, 384, 1024, 2100)])
def test_mm_kernel_matches_port_last_block(q, d, bn, n):
    """The TPU probe's ``[Q, 1]`` is the last block's row max: the last
    column of the port's ``[Q, nb]``, whose every column is checked
    against float64 too."""
    mm_kernel = script_defs("exp_dense_roofline.py", "mm_kernel")["mm_kernel"]
    rng = np.random.default_rng(q + n)
    dpad = padded_docs_t(rng, d, n, bn)
    qs = bf16(rng, q, d, unit_axis=1)
    nb = dpad.shape[1] // bn
    want = pl.pallas_call(
        mm_kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((q, d), lambda j: (0, 0)),
                  pl.BlockSpec((d, bn), lambda j: (0, j))],
        out_specs=pl.BlockSpec((q, 1), lambda j: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(qs, jnp.bfloat16), jnp.asarray(dpad, jnp.bfloat16))
    got = x2.mm_rowmax(to_torch_bf16(qs), to_torch_bf16(dpad), bn)
    assert got.shape == (q, nb) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, -1:].numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    s64 = qs.astype(np.float64) @ dpad.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), s64.reshape(q, nb, bn).max(-1),
                               rtol=0, atol=TOL)


# -- X3 and K1's body: the row-major segment max --------------------------


def _rm_launch(kernel, qs, docs, n_valid, bn):
    """The JAX scripts' row-major phase-1 launch: grid (1, nb), query-
    major ``qt [D, Q]``, output ``[n_segs, Q]``."""
    n_pad, d = docs.shape
    q = qs.shape[0]
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(1, n_pad // bn),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((d, q), lambda i, j: (0, i)),
            pl.BlockSpec((bn, d), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((bn // 8, q), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((n_pad // 8, q), jnp.float32),
        interpret=True,
    )(jnp.asarray([n_valid], jnp.int32), jnp.asarray(qs.T, jnp.bfloat16),
      jnp.asarray(docs, jnp.bfloat16)))


@pytest.mark.parametrize("body", ["X3 segmax_rm_kernel",
                                  "K1 _segmax_rm_kernel untransposed"])
@pytest.mark.parametrize("q,d,bn,n,n_valid", [
    (8, 384, 256, 700, 613), (64, 128, 1024, 2048, 2048), (16, 64, 512, 1500, 1001),
])
def test_rowmajor_bodies_match_k1_reference(body, q, d, bn, n, n_valid):
    """Both row-major bodies the experiments launch compute K1's map
    (written segment-major, ``[n_segs, Q]``): rows ``>= n_valid`` at the
    finite fp32 minimum, the max over each 8-row segment."""
    if body.startswith("X3"):
        kernel = functools.partial(
            script_defs("exp_twophase_rowmajor.py", "NEG", "segmax_rm_kernel")[
                "segmax_rm_kernel"], block_n=bn, seg_rows=8)
    else:
        kernel = functools.partial(
            jdense._segmax_rm_kernel, block_n=bn, seg_rows=8,
            precision=jax.lax.Precision.DEFAULT, transpose_out=False)
    rng = np.random.default_rng(q + n)
    n_pad = -(-n // bn) * bn
    docs = np.zeros((n_pad, d), np.float32)
    docs[:n] = bf16(rng, n, d, unit_axis=1)
    qs = bf16(rng, q, d, unit_axis=1)
    want = _rm_launch(kernel, qs, docs, n_valid, bn)
    got = k1.segmax_rm_reference(to_torch_bf16(qs), to_torch_bf16(docs),
                                 n_valid, 8)
    assert got.shape == (q, n_pad // 8)
    np.testing.assert_allclose(got.T.numpy(), want, rtol=0, atol=TOL)


# -- K4 at seg_rows 32 ----------------------------------------------------


@pytest.mark.parametrize("n,n_valid", [(8000, 7001), (12288, 12288)])
def test_segmax_cm_seg_rows_32_matches_jax_kernel(n, n_valid):
    """The TPU kernel ``_segmax_kernel`` at seg_rows 32 (block_n 4096, the
    smallest it takes) in interpret mode equals K4's plain map."""
    assert 32 in k4.SUPPORTED_SEG_ROWS
    rng = np.random.default_rng(n)
    d, q, bn, sr = 384, 8, 4096, 32
    dpad = padded_docs_t(rng, d, n, bn)
    qs = bf16(rng, q, d, unit_axis=1)
    nb = dpad.shape[1] // bn
    segs = bn // (sr * 128) * 128
    kernel = functools.partial(jdense._segmax_kernel, block_n=bn, seg_rows=sr,
                               n_real=n, precision=jax.lax.Precision.DEFAULT)
    want = pl.pallas_call(
        kernel,
        grid=(1, nb),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((q, d), lambda i, j: (i, 0)),
            pl.BlockSpec((d, bn), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((q, segs), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((q, nb * segs), jnp.float32),
        interpret=True,
    )(jnp.asarray([n_valid], jnp.int32), jnp.asarray(qs, jnp.bfloat16),
      jnp.asarray(dpad, jnp.bfloat16))
    got = k4.segmax_cm_reference(to_torch_bf16(qs), to_torch_bf16(dpad[:, :n]),
                                 n_valid, sr)
    assert got.shape == (q, k4.n_segments(n, sr)) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_twophase_seg_rows_32_matches_jax():
    rng = np.random.default_rng(32)
    docs = bf16(rng, 9000, 64, unit_axis=1)
    docs[4000] = docs[8500] = docs[77]
    qs = np.concatenate([docs[77:78], bf16(rng, 4, 64, unit_axis=1)])
    ref_s, ref_i = jdense.dense_topk_twophase(
        jnp.asarray(qs), jnp.asarray(docs.T), 10, block_n=4096, block_q=8,
        seg_rows=32, interpret=True)
    got_s, got_i = tdense.dense_topk_twophase(torch.from_numpy(qs),
                                              torch.from_numpy(docs.T.copy()),
                                              10, seg_rows=32)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)
    assert got_i[0][:3].tolist() == [77, 4000, 8500]


# -- the two-level segment select -----------------------------------------


def test_two_level_threshold_is_the_jax_constant():
    assert tdense._TWO_LEVEL_MIN_SEGS == jdense._TWO_LEVEL_MIN_SEGS


@pytest.mark.parametrize("n_segs,kk,sup", [
    (4096, 74, 16), (4096, 74, 32), (8192, 74, 64), (16384, 20, 128),
    (4096, 74, None), (4000, 30, 64), (1024, 74, 32),
])
def test_select_segments_matches_jax(monkeypatch, n_segs, kk, sup):
    """The same segment set as JAX's ``_select_segments`` with the
    two-level threshold lowered on both sides; ``sup=None`` and the
    cases the two-level branch declines (``sup`` not dividing the map,
    fewer than ``kk`` super-segments) take the flat select."""
    monkeypatch.setattr(jdense, "_TWO_LEVEL_MIN_SEGS",
                        1 if sup is not None else 1 << 40)
    monkeypatch.setattr(tdense, "_TWO_LEVEL_MIN_SEGS", 1)
    seg_m = np.random.default_rng(n_segs + kk).standard_normal(
        (5, n_segs)).astype(np.float32)
    want = np.asarray(jdense._select_segments(
        jnp.asarray(seg_m), kk, n_segs, **({} if sup is None else {"sup": sup})))
    got = tdense.select_segments(torch.from_numpy(seg_m), kk, sup)
    assert got.shape == (5, kk)
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=1),
                                  np.sort(want, axis=1))


@pytest.mark.parametrize("sup", [16, 64])
def test_twophase_rm_with_sup_matches_jax(monkeypatch, sup):
    monkeypatch.setattr(jdense, "_TWO_LEVEL_MIN_SEGS", 1)
    monkeypatch.setattr(tdense, "_TWO_LEVEL_MIN_SEGS", 1)
    rng = np.random.default_rng(sup)
    docs = bf16(rng, 65536, 64, unit_axis=1)
    docs[[900, 30000, 65000]] = docs[5]
    qs = np.concatenate([docs[5:6], bf16(rng, 7, 64, unit_axis=1)])
    ref_s, ref_i = jdense.dense_topk_twophase_rm(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(docs, jnp.bfloat16), 10,
        block_n=8192, seg_rows=8, sup=sup, interpret=True)
    got_s, got_i = tdense.dense_topk_twophase_rm(
        to_torch_bf16(qs), to_torch_bf16(docs), 10, sup=sup)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)
    assert got_i[0][:4].tolist() == [5, 900, 30000, 65000]


# -- the experiment scripts on the CPU ------------------------------------


TINY = {
    "exp_dense_roofline": dict(n=80_000, stream_bn=(1024, 4096),
                               matmul_bn=(1024, 2048),
                               segmax_cases=((4096, 8), (4096, 32))),
    "exp_twophase_stages": dict(n=20_000),
    "exp_twophase_rowmajor": dict(n=20_000),
    "exp_rm_stages": dict(n=65_536),
    "exp_select_variants": dict(n=65_536),
    "exp_member_topk": dict(n=65_536),
}


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_script_runs_on_cpu_untimed_and_exact(monkeypatch, name):
    """Each experiment's ``run(device="cpu")`` at a tiny size, with the
    two-level select forced: every row untimed, every checked top-10
    equal to the flat select's, the row-major recall 1.0."""
    monkeypatch.setattr(tdense, "_TWO_LEVEL_MIN_SEGS", 1)
    script = importlib.import_module(f"legal_rag_tpu_torch.scripts.{name}")
    lines = []
    rows = script.run(device="cpu", log=lines.append, **TINY[name])
    assert rows and len(lines) >= len(rows)
    assert all(r["ms"] is None and r["gbps"] is None for r in rows)
    assert all(r["match"] for r in rows if "match" in r)
    recalls = [r["recall"] for r in rows if "recall" in r]
    assert recalls == ([1.0] if name == "exp_twophase_rowmajor" else [])
    assert any("match" in r for r in rows) == (name != "exp_dense_roofline")


def test_roofline_keeps_the_jax_sections():
    from legal_rag_tpu_torch.scripts import exp_dense_roofline as roof

    rows = roof.run(n=80_000, sections=["p2"], device="cpu", log=lambda s: None)
    assert {r["section"] for r in rows} == {"p2"}
    names = [r["name"] for r in rows]
    assert names[1] == "p2 approx_max_k" and "note" in rows[1]
    assert len(names) == 7


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_script_main_needs_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = importlib.import_module(f"legal_rag_tpu_torch.scripts.{name}")
    assert script.main() != 0
    assert "needs a CUDA card" in capsys.readouterr().err


def test_new_modules_import_with_jax_blocked():
    """The probes and the experiments stand alone, like every module of
    the port (tests/test_torch_imports.py scans their sources too)."""
    modules = ["legal_rag_tpu_torch.ops.stream_probe",
               "legal_rag_tpu_torch.ops.mm_rowmax",
               "legal_rag_tpu_torch.scripts.exp_common",
               *(f"legal_rag_tpu_torch.scripts.{n}" for n in SCRIPT_NAMES)]
    code = ("import importlib, sys\n"
            "for name in ('jax', 'optax', 'legal_rag_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SCRIPTS.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# -- the wrappers' device rule --------------------------------------------


def test_cpu_tensors_take_the_plain_versions_uncounted():
    before = (x1.X1.launches, x2.X2.launches)
    x1.stream_probe(torch.ones(8, 256).bfloat16(), 128)
    x2.mm_rowmax(torch.ones(2, 32).bfloat16(), torch.ones(32, 256).bfloat16(), 128)
    assert (x1.X1.launches, x2.X2.launches) == before


def test_non_cpu_tensors_never_reach_the_plain_versions():
    d = torch.empty(384, 8192, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        x1.stream_probe(d, 8192)
    with pytest.raises(ValueError, match="CUDA"):
        x2.mm_rowmax(torch.empty(64, 384, device="meta", dtype=torch.bfloat16),
                     d, 8192)


def test_probes_refuse_a_ragged_block():
    with pytest.raises(ValueError, match="multiple of block_n"):
        x1.stream_probe(torch.ones(4, 300).bfloat16(), 128)
    with pytest.raises(ValueError, match="multiple of block_n"):
        x2.mm_rowmax(torch.ones(2, 4).bfloat16(), torch.ones(4, 300).bfloat16(),
                     128)


# -- the kernels against their plain versions on the card -----------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels X1, X2 and K4 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,bn", [(384, 100_000, 8192), (384, 1_000_000, 65536),
                                    (24, 5000, 1024)])
def test_stream_probe_kernel_matches_plain_on_gpu(cuda, d, n, bn):
    g = torch.Generator(device=cuda).manual_seed(n)
    n_pad = -(-n // bn) * bn
    docs_t = torch.zeros(d, n_pad, device=cuda, dtype=torch.bfloat16)
    docs_t[:, :n] = torch.randn(d, n, generator=g, device=cuda).bfloat16()
    docs_t[d // 2, n // 3] = 9.0                     # one block's max
    before = x1.X1.launches
    got_m, got_t = x1.stream_probe(docs_t, bn)
    ref_m, ref_t = x1.stream_probe_reference(docs_t, bn)
    torch.cuda.synchronize()
    assert x1.X1.launches == before + 1
    assert torch.equal(got_m, ref_m)
    assert abs(float(got_t) - float(ref_t)) <= 1e-6 * abs(float(ref_t))


@pytest.mark.gpu
@pytest.mark.parametrize("q,d,n,bn", [(64, 384, 100_000, 8192),
                                      (19, 96, 20_000, 1024),
                                      (70, 384, 40_000, 128)])
def test_mm_rowmax_kernel_matches_plain_on_gpu(cuda, q, d, n, bn):
    g = torch.Generator(device=cuda).manual_seed(q)
    n_pad = -(-n // bn) * bn
    docs = torch.randn(n, d, generator=g, device=cuda)
    docs_t = torch.zeros(d, n_pad, device=cuda, dtype=torch.bfloat16)
    docs_t[:, :n] = (docs / docs.norm(dim=1, keepdim=True)).T.bfloat16()
    qs = torch.randn(q, d, generator=g, device=cuda)
    qs = (qs / qs.norm(dim=1, keepdim=True)).bfloat16()
    before = x2.X2.launches
    got = x2.mm_rowmax(qs, docs_t, bn)
    ref = x2.mm_rowmax_reference(qs, docs_t, bn)
    torch.cuda.synchronize()
    assert x2.X2.launches == before + 1
    torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmax_cm_seg_rows_32_kernel_matches_plain_on_gpu(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(32)
    n = 300_001
    docs_t = torch.randn(384, n, generator=g, device=cuda)
    docs_t = (docs_t / docs_t.norm(dim=0, keepdim=True)).to(dtype)
    q = torch.randn(64, 384, generator=g, device=cuda).to(dtype)
    for n_valid in (n, n - 4097):
        got = k4.segmax_cm(q, docs_t, n_valid, 32)
        ref = k4.segmax_cm_reference(q, docs_t, n_valid, 32)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (64, k4.n_segments(n, 32))
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)
