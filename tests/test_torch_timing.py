"""``legal_rag_tpu_torch.utils.timing`` on its own: the stage timer's
counts and means, its lock under concurrent stages, the profiler range
each stage emits under ``LEGAL_RAG_PROFILE``, and ``device_trace``'s
Chrome trace, all on the CPU with torch's profiler (never jax's)."""

import threading

import pytest
import torch

from legal_rag_tpu_torch.utils.timing import StageTimer, device_trace


def test_stage_timer_counts_and_means():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("encode"):
            pass
    with pytest.raises(RuntimeError):
        with timer.stage("device_search"):
            raise RuntimeError("a failing stage is still timed")
    snap = timer.snapshot()
    assert snap["encode"]["count"] == 3
    assert snap["device_search"]["count"] == 1
    for v in snap.values():
        assert v["total_s"] >= 0 and v["mean_ms"] >= 0 and v["last_ms"] >= 0
        assert v["mean_ms"] == pytest.approx(1e3 * v["total_s"] / v["count"])
    timer.reset()
    assert timer.snapshot() == {}


def test_stage_timer_loses_no_update_across_threads():
    timer = StageTimer()

    def work():
        for _ in range(200):
            with timer.stage("postings"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert timer.snapshot()["postings"]["count"] == 8 * 200


def test_profiled_stage_is_a_named_torch_profiler_range(monkeypatch):
    monkeypatch.setenv("LEGAL_RAG_PROFILE", "1")
    timer = StageTimer()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as prof:
        with timer.stage("rerank_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "rerank_stage" in names
    assert timer.snapshot()["rerank_stage"]["count"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
