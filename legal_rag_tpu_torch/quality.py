"""End-to-end quality gate.

The port of ``legal_rag_tpu.quality``. The suites, the thresholds and
``validate_result`` are the JAX package's verbatim. ``run_retrieval_gate``
and ``run_quality_eval`` build their engines on ``device`` (default the
card), and ``_provenance`` reads the platform, the card's name and the
device count from the engine's torch device, not from JAX.

The reference's eval harness (test_quality.py:10-103): a labeled query
suite run through the full engine with pass/fail rules — answer length,
source presence, and victim-context queries must carry a safety alert
and an action plan. This version runs offline (deterministic paths) or
with an LLM, and throttles only when an LLM client is actually in use
(the reference always sleeps 20 s for rate limits).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

# (query, expected_context, grounding) — victim queries must produce
# safety fields; grounding (optional) is a set of section_id prefixes
# of which at least one must appear in the retrieved context, pinning
# retrieval quality end-to-end (keyword side is deterministic even
# with a random-weight encoder)
QUALITY_SUITE = (
    ("I was robbed at gunpoint just now, what do I do?",
     "victim_distress", None),
    ("Someone just assaulted my sister, help us", "victim_distress", None),
    ("My house was burgled and my jewellery was stolen",
     "victim_distress", None),
    ("I have been cheated by an online seller", "victim_distress", None),
    ("What is the punishment for robbery under BNS?",
     "informational", ("BNS_",)),
    ("What is a Zero FIR?", "informational", ("GSOP_", "BNSS_")),
    ("Is rape a bailable offence?", "informational", None),
    ("How much compensation can an acid attack victim get?",
     "informational", ("NALSA_",)),
    ("What is the procedure to file an FIR electronically?",
     "informational", ("GSOP_", "BNSS_")),
    ("Which sections of BNSS deal with medical examination of victims?",
     "informational", ("BNSS_", "GSOP_")),
)

# Paraphrase gate (round 4, VERDICT r3 item 6): the 10-query core
# suite saturated at 10/10 two rounds running because its phrasing
# lexically overlaps the section headers (BM25 alone passes it). These
# queries describe the scenario WITHOUT the statute's vocabulary —
# "grabbed my gold chain and sprinted off" never says "snatching" — so
# passing requires the trained dense side (the sibling-span finetune's
# whole point, BASELINE.md paraphrase table). ``expected_context="any"``
# skips the safety-field checks: what this suite gates is retrieval
# grounding under paraphrase, not the intent classifier's keyword
# heuristics. Untrained/CPU-fallback stores are EXPECTED to fail rows
# here — that is the gate regaining discriminative power; serving
# stores (build --finetune-steps 4000) must pass
# PARAPHRASE_PASS_THRESHOLD of them.
PARAPHRASE_SUITE = (
    ("A man grabbed my gold chain and sprinted off before I could react",
     "any", ("BNS_304", "BNS_303", "BNS_309")),
    ("My ex keeps following me around and contacting me even after I "
     "told him to stop", "any", ("BNS_78",)),
    ("Someone threw a corrosive liquid at my cousin's face",
     "any", ("BNS_124", "NALSA_")),
    ("How many hours can the police hold someone before producing them "
     "in front of a judge?", "any", ("BNSS_58", "BNSS_57", "BNSS_78")),
    ("Can the court order the offender to pay for my hospital bills "
     "after the attack?", "any", ("BNSS_396", "BNSS_395", "NALSA_")),
    ("What does the law say about a doctor examining a woman after a "
     "sexual offence?", "any", ("BNSS_184", "BNSS_51", "BNSS_52")),
    ("My husband's family keeps demanding cash and a car from my "
     "parents", "any", ("BNS_85", "BNS_80")),
    ("Someone is spreading made-up stories that ruined my standing in "
     "the community", "any", ("BNS_351", "BNS_356")),
    ("A shopkeeper sold me fake gold jewellery claiming it was real",
     "any", ("BNS_318", "BNS_319")),
    ("A stranger lured my eight year old nephew away from the park",
     "any", ("BNS_97", "BNS_137", "BNS_139", "BNS_140")),
)

# Measured round 4 (CPU, top-5 served context through the full
# orchestrator): untrained tiny store 2/10; the round-3 CE/mv store
# 0/10 with AND without the reranker — these queries are genuinely
# hard end-to-end, which is the point (the core suite saturated).
# The threshold is therefore a REGRESSION FLOOR at today's best
# measured capability, not an aspiration: it ratchets UP as recipes
# improve. The 4000-step TPU serving store (ft4000 + mv32 + 12k CE)
# measured exactly 2/10 (quality_report.json, late round 4) — the
# floor is confirmed at the serving recipe, not just the untrained
# store. A build that grounds fewer has lost capability the stack
# already demonstrated.
PARAPHRASE_PASS_THRESHOLD = 2


def validate_result(
    result: Dict, expected_context: str, grounding=None
) -> List[str]:
    """Returns a list of failure strings (empty = pass)."""
    failures: List[str] = []
    resp = result.get("response", {})
    answer = resp.get("answer") or ""
    if len(answer) < 10:
        failures.append(f"answer too short ({len(answer)} chars)")
    if not resp.get("sources"):
        failures.append("no sources")
    if not resp.get("disclaimer"):
        failures.append("missing disclaimer")
    if expected_context == "victim_distress":
        if not resp.get("safety_alert"):
            failures.append("victim query missing safety_alert")
        if not resp.get("immediate_action_plan"):
            failures.append("victim query missing immediate_action_plan")
    elif expected_context != "any":
        # "any" (paraphrase suite) gates grounding only — the intent
        # label is the classifier's call either way
        if resp.get("safety_alert"):
            failures.append("informational query has safety_alert")
    if grounding:
        sids = [
            c.get("section_id") or ""
            for c in result.get("context_used", [])
        ]
        if not any(
            sid.startswith(prefix) for sid in sids for prefix in grounding
        ):
            failures.append(
                f"retrieval missed expected sources {grounding}; got {sids}"
            )
    return failures


# Big-split retrieval gate (VERDICT r3 item 6): the 1,042-query
# structure split + 1,000-query sibling-span split are the framework's
# real quality instruments (the 10-query E2E suite saturated). These
# thresholds pin the SERVING recipe (build --finetune-steps 4000,
# BASELINE.md round-3 recipe table: structure RRF r@10 0.96+, sibling
# dense r@10 0.691) — a serving build that regresses below them fails
# `python -m legal_rag_tpu eval-gate`. CI runs the same machinery on a
# tiny untrained store with its own floor (tests/test_quality_cli.py),
# which catches harness/regression bugs, not recipe drift.
RETRIEVAL_GATE_THRESHOLDS = {
    "structure": {"mode": "rrf", "recall@10": 0.96},
    "sibling": {"mode": "dense", "recall@10": 0.65},
    "sibling_rrf": {"split": "sibling", "mode": "rrf", "recall@10": 0.60},
}


def run_retrieval_gate(
    store,
    thresholds: Optional[Dict] = None,
    engine=None,
    max_queries: Optional[int] = None,
    report_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Pass/fail gate over the big eval splits.

    Returns a report with per-split measured metrics, the thresholds,
    and ``gate_passed``. ``max_queries`` caps each split (CI tiny
    configs); the serving gate runs the full splits. Without
    ``engine`` the gate builds one on ``device``.
    """
    from legal_rag_tpu_torch.evaluation import (
        evaluate_store, labeled_pairs_from_chunks,
        sibling_span_pairs_from_chunks,
    )
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

    thresholds = thresholds or RETRIEVAL_GATE_THRESHOLDS
    engine = engine or RetrievalEngine(store, device=device)

    splits = {
        "structure": labeled_pairs_from_chunks(
            store.chunks, max_pairs=max_queries
        ),
        "sibling": sibling_span_pairs_from_chunks(
            store.chunks, max_pairs=max_queries
        ),
    }
    needed_modes: Dict[str, set] = {"structure": set(), "sibling": set()}
    for name, th in thresholds.items():
        split = th.get("split", name)
        needed_modes[split].add(th["mode"])
    reports = {}
    for split, modes in needed_modes.items():
        if not modes:
            continue
        reports[split] = evaluate_store(
            store, splits[split], modes=tuple(sorted(modes)),
            engine=engine,
        )

    checks = []
    for name, th in thresholds.items():
        split = th.get("split", name)
        measured = reports[split]["modes"][th["mode"]]
        for metric, floor in th.items():
            if metric in ("mode", "split"):
                continue
            got = measured.get(metric)
            checks.append({
                "name": name,
                "split": split,
                "mode": th["mode"],
                "metric": metric,
                "threshold": floor,
                "measured": got,
                "passed": got is not None and got >= floor,
            })
    report = {
        "gate_passed": all(c["passed"] for c in checks),
        "checks": checks,
        "n_queries": {s: len(p) for s, p in splits.items()},
        "provenance": _provenance(engine),
        "splits": {
            s: {"modes": r["modes"]} for s, r in reports.items()
        },
    }
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)
    return report


def _provenance(engine) -> Dict:
    """Stamp WHAT was evaluated into the report (VERDICT r3 item 8): a
    10/10 on a CPU-fallback store must be distinguishable from the
    gated serving build by the artifact alone. The JAX package reads
    its backend; the port reads the engine's torch device: ``platform``
    ``"gpu"`` (JAX's word for an NVIDIA backend) on a CUDA device, with
    the card's name and the process's card count, else ``"cpu"``."""
    import torch

    inner = getattr(engine, "engine", engine)
    device = torch.device(getattr(inner, "device", "cpu"))
    if device.type == "cuda":
        prov: Dict = {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(device),
            "n_devices": torch.cuda.device_count(),
        }
    else:
        prov = {"platform": "cpu", "device_kind": "cpu", "n_devices": 1}
    store = getattr(engine, "store", None) or getattr(
        getattr(engine, "engine", None), "store", None
    )
    if store is not None:
        prov.update(
            n_docs=getattr(store, "n_docs", None),
            corpus_hash=(getattr(store, "corpus_hash", "") or "")[:16],
            cross_encoder=getattr(store, "ce_params", None) is not None,
            multi_vector=getattr(store, "mv_tokens", None) is not None,
            build_params=getattr(store, "build_params", None),
        )
        emb = getattr(store, "embeddings", None)
        if emb is not None:
            prov["embedding_dtype"] = str(emb.dtype)
    inner = getattr(engine, "engine", engine)
    cfg = getattr(inner, "config", None)
    if cfg is not None:
        prov["dense_dtype"] = cfg.dense.dtype
        prov["fusion_mode"] = cfg.fusion.mode
        # r5 narrative-form routing changes serving behavior; a report
        # with the policy on must be distinguishable from one without
        prov["narrative_mode"] = cfg.fusion.narrative_mode
    return prov


def run_quality_eval(
    store_dir=None,
    engine=None,
    report_path: Optional[str] = None,
    suite=QUALITY_SUITE,
    llm_throttle_s: float = 20.0,
    include_paraphrase: bool = False,
    device="cuda",
) -> Dict:
    """Run the suite; returns (and optionally writes) the report.

    ``include_paraphrase``: additionally run :data:`PARAPHRASE_SUITE`
    and report its grounded count against
    :data:`PARAPHRASE_PASS_THRESHOLD` (``paraphrase_gate_passed``) —
    the serving-store gate; untrained stores are expected to fail it.

    The JAX package's function but for ``device``: without ``engine``
    the ``LegalEngine`` is built on it (the one line that differs).
    """
    if engine is None:
        import dataclasses

        from legal_rag_tpu_torch.config import DEFAULT_CONFIG, FusionConfig
        from legal_rag_tpu_torch.retrieval.facade import LegalEngine

        # the gate evaluates the framework's best configuration: RRF
        # lets keyword-only hits surface (the weighted parity mode
        # cannot — the reference's blind spot), which matters whenever
        # the encoder is untrained/offline
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, fusion=FusionConfig(mode="rrf")
        )
        engine = LegalEngine(store_dir=store_dir, config=cfg, device=device)

    uses_llm = (
        getattr(engine.responder, "llm", None) is not None
        or getattr(engine.orchestrator.classifier, "llm", None) is not None
    )

    def run_suite(cases):
        rows = []
        for i, case in enumerate(cases):
            query, expected_context = case[0], case[1]
            grounding = case[2] if len(case) > 2 else None
            t0 = time.time()
            try:
                out = engine.query(query)
                failures = validate_result(out, expected_context, grounding)
                detected = out.get("intent", {}).get("user_context")
            except Exception as e:  # noqa: BLE001 — a crash is a failure
                out = None
                failures = [f"exception: {e}"]
                detected = None
            rows.append({
                "query": query,
                "expected_context": expected_context,
                "detected_context": detected,
                "passed": not failures,
                "failures": failures,
                "latency_s": round(time.time() - t0, 3),
            })
            if uses_llm and i + 1 < len(cases):
                time.sleep(llm_throttle_s)
        return rows

    results = run_suite(suite)
    report = {
        "total": len(results),
        "passed": sum(1 for r in results if r["passed"]),
        "uses_llm": uses_llm,
        "provenance": _provenance(engine),
        "results": results,
    }
    if include_paraphrase:
        if uses_llm:
            # run_suite throttles BETWEEN its own queries; the boundary
            # between the core and paraphrase suites needs the same gap
            # or a rate-limit hit there records a spurious 'exception:'
            # failure against the paraphrase gate
            time.sleep(llm_throttle_s)
        para = run_suite(PARAPHRASE_SUITE)
        n_pass = sum(1 for r in para if r["passed"])
        report["paraphrase"] = {
            "total": len(para),
            "passed": n_pass,
            "threshold": PARAPHRASE_PASS_THRESHOLD,
            "gate_passed": n_pass >= PARAPHRASE_PASS_THRESHOLD,
            "results": para,
        }
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)
    return report
