"""Dynamic updates: the host bookkeeping of upsert / delete / rebalance
(port of scann_tpu/mutation.py, host numpy, kept as its own copy).

A mutable searcher keeps a float32 mirror of every row it was given
(``vectors``, in id order), an alive mask and the docid -> id map.  An
upsert of a known docid overwrites its row in place (an update); an
unknown docid appends a row and takes the next id.  A delete tombstones
the row.  ``rebalance`` retrains the index on the live rows, which
renumbers them.  Counting the mutations since the last (re)build gives the
incremental threshold its trigger: a float below 1.0 is a fraction of the
index, anything else a count of rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class MutationState:
    """Host-side bookkeeping shared by mutable searchers."""

    def __init__(self, database: np.ndarray, docids: Optional[list]):
        self.vectors = np.array(database, np.float32, copy=True)
        self.alive = np.ones(len(database), bool)
        self.docid_to_id = None
        if docids is not None:
            self.docid_to_id = {d: i for i, d in enumerate(docids)}
        self.mutations_since_rebuild = 0

    def live_database(self):
        """(vectors, ids kept) with tombstones dropped."""
        keep = np.nonzero(self.alive)[0]
        return self.vectors[keep], keep

    def append(self, vecs: np.ndarray):
        start = len(self.vectors)
        self.vectors = np.concatenate([self.vectors, vecs], axis=0)
        self.alive = np.concatenate([self.alive, np.ones(len(vecs), bool)])
        return np.arange(start, start + len(vecs))


def resolve_upsert_ids(state: MutationState, docids, n_new: int):
    """The id each upserted row overwrites, or -1 for a new docid."""
    if state.docid_to_id is None:
        raise ValueError("upsert/delete require the searcher to be built "
                         "with docids")
    if len(docids) != n_new:
        raise ValueError("Number of items mismatch in docids and database "
                         "vectors")
    existing = np.full(n_new, -1, np.int64)
    for i, d in enumerate(docids):
        if d in state.docid_to_id:
            existing[i] = state.docid_to_id[d]
    return existing


def incremental_threshold_exceeded(part_cfg, state: MutationState,
                                   n_points: int) -> bool:
    """True once the mutations since the last (re)build exceed the
    partitioning's incremental threshold: a float below 1.0 is a fraction
    of ``n_points``, anything else a count."""
    if part_cfg is None or part_cfg.incremental_threshold is None:
        return False
    thr = part_cfg.incremental_threshold
    if isinstance(thr, float) and thr < 1.0:
        return state.mutations_since_rebuild > thr * max(n_points, 1)
    return state.mutations_since_rebuild > int(thr)
