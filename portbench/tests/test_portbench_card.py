"""On the card: a tiny cell of each configuration through the kernels,
traced, is correct and reads every per-layer metric; the control fails
there too; the corpus is the same for the same seed."""

import pytest
import torch
from conftest import run_tiny, tiny_config

from portbench.harness import spec

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_cell_on_the_card(card, workload):
    r = run_tiny(workload, trace=True, device=card, seconds=2.0)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in spec.cell_metrics(B, workload, "per_layer")}
    assert set(r["metrics"]) == want
    assert 0 < r["metrics"]["score_roofline"]["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    assert not run_tiny(workload, variant="control", device=card)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_corpus_repeats_for_a_seed(card, config):
    c = tiny_config(config)["corpus"]
    make = spec.module("corpora", c["generator"]).make
    a = make(c, 2 ** 31 + 5, 64, card)
    b = make(c, 2 ** 31 + 5, 64, card)
    other = make(c, 2 ** 31 + 6, 64, card)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], other[0])
