"""The SOAR cell (glove100-soar.batch10k) through the harness: a tiny CPU
run is correct with no bad row, a traced one reads its two dedup metrics
as nothing (the CPU trace holds no device work) without raising, and the
readers take the dedup stage's device time and launches from a chrome
trace, or nothing from a program that marks no such stage.  On the card
test_portbench_card.py reads both from a real traced run."""

import numpy as np
import pytest
from conftest import run_tiny

from portbench.harness import core, spec, trace

CELL = "glove100-soar.batch10k"
METRICS = ("dedup_ms", "dedup_launches.batch")


def test_tiny_soar_run_is_correct():
    r = run_tiny(CELL, seed=2 ** 31 + 23)
    assert r["correct"], r["checks"]
    assert r["checks"]["bad_rows"]["value"] == 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_traced_cpu_run_reads_no_dedup_metric():
    r = run_tiny(CELL, trace=True)
    assert r["correct"], r["checks"]
    assert not set(METRICS) & set(r["metrics"])


@pytest.mark.parametrize("factor", [2.0, 1.5, None])
def test_spilled_work_hands_on_k_fetch(factor):
    """lut_int8_spilled is lut_int8 with ceil(k_pre * overretrieve_factor)
    candidates a query handed on (k_pre itself without the factor)."""
    sizes, leaves = np.array([5, 0, 7, 3]), np.array([[0, 2], [2, 3]])
    keep = np.array([[True, True], [True, False]])
    index = {"steps": {"tree": {"overretrieve_factor": factor},
                       "score_ah": {"dimensions_per_block": 2}}}
    got = spec.module("work", "lut_int8_spilled").count(
        leaves, keep, sizes, 2, 10, 5, index)
    k_fetch = {2.0: 10, 1.5: 8, None: 5}[factor]
    assert got == spec.module("work", "lut_int8").count(
        leaves, keep, sizes, 2, 10, k_fetch, index)


def X(name, ts, dur, cat, corr=None, tid=1):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _run_of(events):
    s = trace.summarize(events)
    run = core.Run(config={}, traffic={}, trace=s)
    run.stage_ms = {k: 1e3 * v / len(s["stage_batches"])
                    for k, v in s["stage_s"].items()}
    return run


@pytest.mark.parametrize("soar", [True, False])
def test_readers_take_the_dedup_stage(soar):
    """One counted batch: merge (one launch, 6 us on the card), then under
    SOAR the dedup stage (two launches, kernels of 3 and 2 us that
    overlap by 1)."""
    ev = [X("portbench.traced", 0, 100, "user_annotation"),
          X("portbench.dispatch", 10, 50, "user_annotation"),
          X("cudaLaunchKernel", 12, 1, "cuda_runtime", corr=1),
          X("stage.merge", 14, 0, "user_annotation"),
          X("merge_k", 20, 6, "kernel", corr=1, tid=7)]
    if soar:
        ev += [X("cudaLaunchKernel", 15, 1, "cuda_runtime", corr=2),
               X("cudaLaunchKernel", 17, 1, "cuda_runtime", corr=3),
               X("stage.dedup", 19, 0, "user_annotation"),
               X("sort_k", 30, 3, "kernel", corr=2, tid=7),
               X("topk_k", 32, 2, "kernel", corr=3, tid=7)]
    run = _run_of(ev)
    got = {m: spec.module("metrics", m).read(run) for m in METRICS}
    if soar:
        assert got["dedup_ms"] == pytest.approx(4e-3)
        assert got["dedup_launches.batch"] == 2.0
    else:
        assert got == {m: None for m in METRICS}
    assert spec.module("metrics", "merge_ms").read(run) == \
        pytest.approx(6e-3)


def test_soar_check_holds_every_bar_on_a_tiny_cell():
    """portbench/tools/soar_check.py's comparison, whole, at the tiny
    size on the CPU."""
    from conftest import tiny_config, tiny_limits, tiny_traffic
    r = spec.module("tools", "soar_check").run_check(
        tiny_config("glove100-soar"), tiny_traffic("batch10k"),
        tiny_limits(CELL), 2 ** 31 + 99, 1.0, "cpu", log=lambda m: None)
    assert r["ok"], r["bars"]
    assert r["answered"] >= r["pool_queries"]
    assert r["secondary_slots"] == r["assignment"]["rows"]
    assert r["assignment"]["rows"] == tiny_config("glove100-soar")[
        "corpus"]["rows"]
