"""Each driver runs a tiny cell end to end on the CPU and gives a
well-formed result line."""

import json

import pytest
from conftest import run_tiny

from portbench.harness import check, spec

B = spec.load_benchmark()


def _well_formed(r, workload, trace):
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-2:] == ["checks", "_info"]
    r = dict(r)
    r.pop("_info")
    line = json.loads(json.dumps(r))
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    section = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"]
             for m in spec.cell_metrics(B, workload, section)}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        for part in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][part]) <= 10
    assert set(line["checks"]) == set(check.NAMES)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    return line


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_batch_driver_end_to_end(workload, trace):
    r = run_tiny(workload, trace=trace)
    line = _well_formed(r, workload, trace)
    assert line["correct"]
    names = set(line["metrics"])
    if trace:
        # On the CPU there is no device trace to read the stages' device
        # time or an idle share from (test_portbench_trace reads them from
        # a hand-made one); the work count is read all the same.
        assert names == {"build_s", "dispatch_ms.batch"}
        assert r["_info"]["work"]["least_ms_per_batch"] > 0
        assert r["_info"]["traced_batches"] > 0
    else:
        assert names == {"qps", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_serve_driver_end_to_end(trace):
    r = run_tiny("glove100-ah.batch10k", traffic="serve", trace=trace)
    info = r["_info"]["window"]
    line = _well_formed(r, "glove100-ah.batch10k", trace)
    assert line["correct"]
    assert info["mean_micro_batch"] >= 1 and info["sent"] > 0
    assert {"p50_ms", "p95_ms"} <= set(info["latency_from_due"])
    assert "p99_ms" in info["generator_late"]
