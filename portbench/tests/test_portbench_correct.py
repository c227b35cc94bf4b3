"""`correct` comes out false under the control and under each fault, and
true for the program, in a whole run with only the look for a card
skipped (tiny sizes, on the CPU), with each cell's own limits but for
recall, which the tiny configurations hold to their own (conftest)."""

import pytest
from conftest import run_tiny

from portbench.harness import faults, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(workload):
    assert run_tiny(workload, seed=2 ** 31 + 17)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_one_precision_down_is_not_correct(workload):
    r = run_tiny(workload, variant="control")
    assert not r["correct"]
    # It finds the neighbours; its TF32 distances are what fails.
    assert r["checks"]["dist_gap"]["value"] > \
        r["checks"]["dist_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    assert not run_tiny(workload, variant=fault)["correct"]
