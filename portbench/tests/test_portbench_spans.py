"""The program spans' reduction (harness/spans.py) on hand-made chrome
traces, and trace.summarize's numbers with and without program spans."""

import pytest

from portbench.harness import spans, trace


def X(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def P(name, ts, dur):
    return X("scann_torch." + name, ts, dur, "cpu_op")


def _batch(t, bid, corr):
    """One dispatch at t: a search span of 100 us (tokenize 10 with a
    4 us register inside, plan 20, score 15, merge 25, reorder 5, finish
    5: 80 us of stages, 75 of them the five layers'), a blocking sync of
    3 us in it, and a launch in each stage."""
    ev = [X("portbench.dispatch", t, 110),
          P("search", t + 5, 100), P(f"batch.{bid}", t + 5, 0),
          X("cudaMemcpyAsync", t + 6, 1, "cuda_runtime", corr=corr),
          X("aten::item", t + 7, 5, "cpu_op"),
          X("cudaStreamSynchronize", t + 8, 3, "cuda_runtime")]
    at = t + 15
    for i, (stage, dur) in enumerate((("tokenize", 10), ("plan", 20),
                                      ("score", 15), ("merge", 25),
                                      ("reorder", 5), ("finish", 5))):
        ev.append(P(stage, at, dur))
        ev.append(X("cudaLaunchKernel", at + 1, 1, "cuda_runtime",
                    corr=corr + 1 + i))
        ev.append(X(f"k_{stage}", at + 2, dur / 2, "kernel", tid=7,
                    corr=corr + 1 + i))
        ev.append(X(f"stage.{stage}", at + dur - 0.5, 0))
        if stage == "tokenize":
            ev.append(P("register", at + 3, 4))
        at += dur
    return ev


def _result(t, bid, corr):
    return [X("portbench.result", t, 30), P("result", t + 2, 20),
            P(f"batch.{bid}", t + 2, 0),
            X("cudaMemcpyAsync", t + 3, 1, "cuda_runtime", corr=corr),
            X("cudaStreamSynchronize", t + 5, 10, "cuda_runtime"),
            X("Memcpy DtoH (Device -> Pageable)", t + 6, 2, "gpu_memcpy",
              tid=7, corr=corr)]


def _trace():
    """The traced span 0-1000 us, settling 0-100: batch 1 dispatched in
    the settling part (not counted), batches 2 and 3 counted; the result
    of batch 2 in the trace, batch 3's after it."""
    return ([X("portbench.traced", 0, 1000)]
            + _batch(20, 1, 100) + _result(150, 1, 150)
            + _batch(200, 2, 200) + _result(350, 2, 250)
            + _batch(400, 3, 300)
            + [X("cudaDeviceSynchronize", 600, 50, "cuda_runtime")])


def test_stage_entry_wait_and_result():
    s = spans.summarize(_trace(), settle_s=100e-6)
    assert s["batches"] == 2
    # tokenize's register child is not the stage's own time.
    assert s["tokenize_host_ms"] == pytest.approx(6e-3)
    assert s["plan_host_ms"] == pytest.approx(20e-3)
    assert s["score_host_ms"] == pytest.approx(15e-3)
    assert s["merge_host_ms"] == pytest.approx(25e-3)
    assert s["reorder_host_ms"] == pytest.approx(5e-3)
    # The search span less its five layer stages: 100 - 75 (finish stays).
    assert s["entry_host_ms.batch"] == pytest.approx(25e-3)
    # The sync inside each search; not the result's, not the one outside.
    assert s["dispatch_wait_ms.batch"] == pytest.approx(3e-3)
    assert s["dispatch_wait_ms_by_span"] == pytest.approx(
        {"search/aten::item": 3e-3})
    # Only batch 2's result is in the trace (batch 1's is not counted).
    assert s["result_host_ms.batch"] == pytest.approx(20e-3)


def test_split_search_counts_once():
    """A split batch: sub-batch searches nest in the outer one, and their
    stages count to the outer batch."""
    ev = [X("portbench.traced", 0, 1000), X("portbench.dispatch", 10, 200),
          P("search", 12, 180), P("batch.1", 12, 0)]
    for i, t in enumerate((20, 100)):
        ev += [P("search", t, 70), P(f"batch.{2 + i}", t, 0),
               P("plan", t + 10, 30), P("score", t + 40, 20)]
    s = spans.summarize(ev)
    assert s["batches"] == 1
    assert s["plan_host_ms"] == pytest.approx(60e-3)
    assert s["score_host_ms"] == pytest.approx(40e-3)
    assert s["entry_host_ms.batch"] == pytest.approx(80e-3)
    assert "result_host_ms.batch" not in s


def test_no_program_spans_no_numbers():
    """The parent's program leaves no span: no number, and no error."""
    ev = [e for e in _trace() if not e["name"].startswith("scann_torch.")]
    assert spans.summarize(ev, 100e-6) is None
    assert spans.summarize([X("k", 0, 1, "kernel")]) is None
    assert spans.setup_seconds({}) == {} and spans.setup_seconds(None) == {}


def test_setup_seconds_from_totals():
    totals = {"build": (3.0, 1), "partition": (1.5, 1),
              "quantize": (0.75, 2), "layout": (0.5, 2),
              "register": (8.0, 3), "search": (9.0, 40)}
    assert spans.setup_seconds(totals) == {
        "partition_s": 1.5, "quantize_s": 0.75, "layout_s": 0.5,
        "register_s": 8.0}


def test_trace_numbers_unchanged_by_program_spans():
    """Every number of trace.summarize reads the same with the program's
    spans in the trace; only the names of idle gaps may name them (and so
    split a gap's seconds otherwise: their sum stays)."""
    ev = _trace()
    plain = [e for e in ev if not e["name"].startswith("scann_torch.")]
    with_spans = trace.summarize(ev, settle_s=100e-6)
    without = trace.summarize(plain, settle_s=100e-6)
    assert without["stage_s"] and without["launches"]
    for key in without:
        if key == "idle_gaps":
            assert sum(v for _, v in with_spans[key]) == \
                pytest.approx(sum(v for _, v in without[key]))
        else:
            assert with_spans[key] == without[key], key
    assert any("scann_torch." in name for name, _ in with_spans["idle_gaps"])


@pytest.mark.parametrize("workload", ["glove100-ah.batch10k",
                                      "sift1m-sq.batch10k"])
def test_span_breakdown_tool_on_a_tiny_run(workload):
    """portbench/tools/span_breakdown.py at a tiny size on the CPU: every
    layer's host ms, the build's phases, and trace.summarize alike without
    the program's spans."""
    import importlib.util
    import os
    import torch
    from portbench.tests.conftest import ROOT, tiny_config, tiny_traffic
    from portbench.harness import spec
    from scann_torch.utils import profiling
    path = os.path.join(ROOT, "portbench", "tools", "span_breakdown.py")
    mod_spec = importlib.util.spec_from_file_location("span_breakdown", path)
    tool = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(tool)
    cell = spec.find(spec.load_benchmark()["workloads"], workload,
                     "workload")
    threads = torch.get_num_threads()
    try:
        # Batches of 20 queries on one thread: a dozen or more of them in
        # the 1.5 s traced, even beside other test processes, so that a
        # counted batch's result falls inside the trace.
        torch.set_num_threads(1)
        out = tool.run(workload, 5, 3.0, True, device="cpu",
                       config=tiny_config(cell["config"]),
                       traffic=dict(tiny_traffic(cell["traffic"]), batch=20,
                                    pool_batches=4),
                       cost_batches=4)
    finally:
        torch.set_num_threads(threads)
        profiling.enable_spans(False)
        profiling.reset_span_totals()
    host = out["host"]
    assert host["batches"] > 0
    for name in spans.LAYER_STAGES:
        assert host[f"{name}_host_ms"] > 0, name
    assert host["entry_host_ms.batch"] > 0
    assert host["result_host_ms.batch"] > 0
    assert {"partition", "quantize", "layout"} <= set(out["build_spans_s"])
    assert abs(out["build_phases_gap_pct"]) < 25
    # The host spans of a batch lie inside its dispatch annotation.
    assert 0 <= out["host_gap_traced_pct"] < 25
    assert out["summarize_differs_without_spans"] == []
    for side in ("untraced", "traced"):
        assert out["span_cost"][side]["on_ms"] > 0
        assert out["span_cost"][side]["off_ms"] > 0
