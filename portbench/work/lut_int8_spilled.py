"""The work of int8-LUT scoring (K3) on a spilled (SOAR) index, from
shapes alone: that of lut_int8.py, with each query handing on the
ceil(k_pre * overretrieve_factor) candidates that a spilled index keeps
before its dedup, in place of k_pre.  The leaf sizes already hold each
row in both of its leaves, so the codes read and the (query, row) pairs
count the second copies."""

import math

from portbench.harness import spec


def count(leaf_ids, valid, leaf_sizes, nq: int, dims: int, k_pre: int,
          index: dict) -> dict:
    factor = index["steps"]["tree"].get("overretrieve_factor") or 1.0
    return spec.module("work", "lut_int8").count(
        leaf_ids, valid, leaf_sizes, nq, dims, math.ceil(k_pre * factor),
        index)
