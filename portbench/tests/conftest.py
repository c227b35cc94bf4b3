"""Helpers of the benchmark's own tests: tiny configurations and traffic
for CPU runs, and a fixture that skips a test without a CUDA card
(decided inside the test, never at import)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import spec  # noqa: E402

TINY_ROWS = 6000
# The tiny configurations' own limit on 1 - recall@10, set from their own
# readings on the CPU: sound runs 0.019-0.044 (SIFT-shaped) and 0.005-0.010
# (glove-shaped) over six seeds, half of each batch left out about 0.5.
# The other limits are the cell's.
TINY_RECALL_SHORT = 0.2


def tiny_config(name: str) -> dict:
    """A configuration at a size a test holds: its widths, measure,
    scorer and reorder as published; 6,000 rows under 40 leaves, 20 of
    them searched."""
    c = copy.deepcopy(spec.load_config(spec.load_benchmark(), name))
    c["corpus"]["rows"] = TINY_ROWS
    if "topics" in c["corpus"]:
        c["corpus"].update(topics=32, subtopics_per_topic=8)
    c["index"]["steps"]["tree"].update(num_leaves=40, num_leaves_to_search=20,
                                       training_sample_size=TINY_ROWS)
    c["search"]["leaves_to_search"] = 20
    return c


def tiny_traffic(name: str) -> dict:
    t = dict(spec.load_traffic(name))
    if "batch" in t:
        t.update(batch=100, pool_batches=2)
    else:
        t.update(rate_qps=200.0, pool_queries=300)
    return t


def tiny_limits(workload: str) -> dict:
    return {**spec.load_limits(workload), "recall_short": TINY_RECALL_SHORT}


def run_tiny(workload, seed=11, seconds=1.0, trace=False, variant=None,
             traffic=None, device="cpu"):
    from portbench.harness import core
    cell = spec.find(spec.load_benchmark()["workloads"], workload,
                     "workload")
    return core.run_cell(
        workload, seed, seconds, trace, device=device, variant=variant,
        config=tiny_config(cell["config"]),
        traffic=tiny_traffic(traffic or cell["traffic"]),
        limits=tiny_limits(workload))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
