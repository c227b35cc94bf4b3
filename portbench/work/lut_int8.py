"""The work of asymmetric-hashing scoring through int8 lookup tables (the
tree-AH int8-LUT scorer, K3), from shapes alone.

For one batch: each distinct searched leaf's codes read once (4-bit codes
with 16 centers a block), the queries once (float32), the codebook once,
and the candidates handed on once (a float32 score and an int32 id for
each of the k_pre candidates of a query).  Operations: each query's
lookup table (a product with every center, bf16 peak) and, for every
(query, searched row) pair, one int8 table entry added a block (int8
peak).  The lookup itself is a table read, not arithmetic.  Nothing is
taken from the program's padded plan: the leaf sizes and leaf lists fix
the work, whatever kernel or plan does it.
"""

import math

import numpy as np

CENTERS = 16


def count(leaf_ids, valid, leaf_sizes, nq: int, dims: int, k_pre: int,
          index: dict) -> dict:
    dpb = index["steps"]["score_ah"]["dimensions_per_block"]
    blocks = math.ceil(dims / dpb)
    code_bytes = blocks * math.log2(CENTERS) / 8
    sizes = np.asarray(leaf_sizes, np.int64)
    searched = np.asarray(leaf_ids)[np.asarray(valid, bool)]
    pairs = int(sizes[searched].sum())
    rows_read = int(sizes[np.unique(searched)].sum())
    nbytes = (rows_read * code_bytes + nq * dims * 4
              + blocks * CENTERS * dpb * 4 + nq * k_pre * 8)
    return {"bytes": float(nbytes), "pairs": pairs,
            "ops": {"bf16": 2.0 * nq * blocks * CENTERS * dpb,
                    "int8": float(pairs * blocks)}}
