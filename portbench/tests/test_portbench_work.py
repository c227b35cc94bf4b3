"""The work counts behind score_roofline, against hand counts on a small
partition."""

import numpy as np
import pytest

from portbench.harness import peaks, spec

SIZES = np.array([5, 0, 7, 3])           # rows in each of 4 leaves
LEAVES = np.array([[0, 2], [2, 3], [1, 0]])
KEEP = np.array([[True, True], [True, False], [True, True]])
# searched (query, leaf): (0,0) (0,2) (1,2) (2,1) (2,0): pairs 5+7+7+0+5;
# distinct leaves {0, 1, 2}: 12 rows read.
PAIRS, ROWS_READ, NQ, K_PRE = 24, 12, 3, 4


def test_lut_int8_hand_count():
    index = {"measure": "dot_product",
             "steps": {"score_ah": {"dimensions_per_block": 2}}}
    w = spec.module("work", "lut_int8").count(LEAVES, KEEP, SIZES, NQ, 10,
                                              K_PRE, index)
    # 5 blocks of 2 dims, 16 centers: 2.5 B of codes a row.
    assert w["pairs"] == PAIRS
    assert w["bytes"] == ROWS_READ * 2.5 + NQ * 10 * 4 + 5 * 16 * 2 * 4 \
        + NQ * K_PRE * 8
    assert w["ops"] == {"bf16": 2.0 * NQ * 5 * 16 * 2, "int8": PAIRS * 5}


@pytest.mark.parametrize("measure,row_bytes", [("dot_product", 12 + 4),
                                               ("squared_l2", 12 + 8)])
def test_sq_int8_hand_count(measure, row_bytes):
    index = {"measure": measure, "steps": {}}
    w = spec.module("work", "sq_int8").count(LEAVES, KEEP, SIZES, NQ, 12,
                                             K_PRE, index)
    assert w["pairs"] == PAIRS
    assert w["bytes"] == ROWS_READ * row_bytes + NQ * 12 * 4 + NQ * K_PRE * 8
    assert w["ops"] == {"bf16": 2.0 * PAIRS * 12}


def test_least_time_is_the_larger_bound():
    w = {"bytes": 3.35e12, "ops": {"bf16": 989e12, "int8": 1979e12}}
    assert peaks.least_seconds(w) == pytest.approx(2.0)
    assert peaks.least_seconds({"bytes": 6.7e12, "ops": {}}) == \
        pytest.approx(2.0)
