"""The work of scoring int8 rows (the tree-SQ scorer, K1), from shapes
alone.

For one batch: each distinct searched leaf's rows read once (one byte a
dimension, a float32 scale a row, and under squared L2 a float32 squared
norm a row), the queries once (float32), and the candidates handed on
once (a float32 score and an int32 id for each of the k_pre candidates
of a query).  Operations: for every (query, searched row) pair, a product
of the row with the query, 2 * dims, at the bf16 peak (the rows meet
bf16 queries; there is no int8 x float product on the tensor cores).
Nothing is taken from the program's padded plan.
"""

import numpy as np


def count(leaf_ids, valid, leaf_sizes, nq: int, dims: int, k_pre: int,
          index: dict) -> dict:
    row_bytes = dims + 4 + (4 if index["measure"] == "squared_l2" else 0)
    sizes = np.asarray(leaf_sizes, np.int64)
    searched = np.asarray(leaf_ids)[np.asarray(valid, bool)]
    pairs = int(sizes[searched].sum())
    rows_read = int(sizes[np.unique(searched)].sum())
    nbytes = rows_read * row_bytes + nq * dims * 4 + nq * k_pre * 8
    return {"bytes": float(nbytes), "pairs": pairs,
            "ops": {"bf16": 2.0 * pairs * dims}}
