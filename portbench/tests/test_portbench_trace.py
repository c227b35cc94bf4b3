"""The trace reduction on a hand-made chrome trace."""

import pytest

from portbench.harness import trace


def X(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_idle_gaps_and_launches():
    ev = [
        X("portbench.traced", 0, 100, "user_annotation"),
        X("portbench.dispatch", 10, 36, "user_annotation"),
        X("cudaLaunchKernel", 12, 1, "cuda_runtime"),
        X("stage.tokenize", 14, 0, "user_annotation"),
        X("cudaLaunchKernel", 16, 1, "cuda_runtime"),
        X("cudaLaunchKernel", 18, 1, "cuda_runtime"),
        X("stage.score", 20, 0, "user_annotation"),
        X("aten::nonzero", 22, 23, "cpu_op"),
        X("portbench.result", 50, 20, "user_annotation"),
        X("cudaMemcpyAsync", 52, 1, "cuda_runtime"),
        X("k1", 13, 7, "kernel", tid=7),           # 13-20
        X("k2", 17, 8, "kernel", tid=7),           # 17-25: union 13-25
        X("Memcpy DtoH", 55, 5, "gpu_memcpy", tid=7),
    ]
    s = trace.summarize(ev, settle_s=5e-6)          # read 5..100 us
    assert s["window_s"] == pytest.approx(95e-6)
    assert s["busy_s"] == pytest.approx(17e-6)
    assert s["batches"] == 1
    assert dict(s["device_ops"]) == pytest.approx(
        {"k1": 7e-6, "k2": 8e-6, "Memcpy DtoH": 5e-6})
    # Idle 5-13 before the dispatch, 25-55 (its middle, 40, in the
    # dispatch's nonzero), 60-100 after the result.
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"outside_dispatch/python": 48e-6,
         "portbench.dispatch/aten::nonzero": 30e-6})
    assert s["launches"] == {"tokenize": 1.0, "score": 2.0, "result": 1.0}


def test_stage_seconds_are_device_time_by_correlation():
    """Each device operation goes to the stage of its launch; idle time
    between two marks counts to no stage; a batch dispatched before the
    settling part ends, and the result copy, to none; a host-to-device
    copy is the upload."""
    ev = [
        X("portbench.traced", 0, 200, "user_annotation"),
        # Dispatched inside the settling part (0-10 us): not counted.
        X("portbench.dispatch", 2, 6, "user_annotation"),
        X("cudaLaunchKernel", 3, 1, "cuda_runtime", corr=1),
        X("stage.tokenize", 5, 0, "user_annotation"),
        X("tok_old", 12, 10, "kernel", tid=7, corr=1),
        # Counted: upload, tokenize, score; marks far apart on the host.
        X("portbench.dispatch", 20, 100, "user_annotation"),
        X("cudaMemcpyAsync", 21, 1, "cuda_runtime", corr=2),
        X("cudaLaunchKernel", 23, 1, "cuda_runtime", corr=3),
        X("stage.tokenize", 30, 0, "user_annotation"),
        X("cuLaunchKernel", 32, 1, "cuda_driver", corr=4),
        X("cudaLaunchKernel", 34, 1, "cuda_runtime", corr=5),
        X("stage.score", 110, 0, "user_annotation"),
        X("portbench.result", 130, 20, "user_annotation"),
        X("cudaMemcpyAsync", 131, 1, "cuda_runtime", corr=6),
        X("Memcpy HtoD (Pageable -> Device)", 25, 2, "gpu_memcpy", tid=7,
          corr=2),
        X("tok", 27, 4, "kernel", tid=7, corr=3),
        X("score_a", 40, 6, "kernel", tid=7, corr=4),
        X("score_b", 44, 6, "kernel", tid=7, corr=5),    # 40-50 in all
        X("Memcpy DtoH (Device -> Pageable)", 140, 3, "gpu_memcpy",
          tid=7, corr=6),
    ]
    s = trace.summarize(ev, settle_s=10e-6)
    assert s["stage_batches"] == [1]
    assert s["stage_s"] == pytest.approx(
        {"upload": 2e-6, "tokenize": 4e-6, "score": 10e-6})
    assert s["launches"] == {"tokenize": 2.0, "score": 2.0, "result": 1.0}


def test_no_span_no_numbers():
    assert trace.summarize([X("k1", 0, 1, "kernel")]) is None
