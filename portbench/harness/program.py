"""Everything the benchmark takes from the program under test, in one
place: the index build through the public builder, and what the work
counts read from the built index (its partition's leaf sizes and a
batch's leaf lists).  scann_torch is imported here and nowhere else in
the harness."""

from __future__ import annotations

import numpy as np
import torch


def build(index: dict, rows: np.ndarray, seed: int, device):
    """The searcher of a configuration's ``index``: ``builder(rows, k,
    measure)`` then each of ``steps`` in order, as builder calls with
    their keyword arguments."""
    import scann_torch
    b = scann_torch.builder(rows, index["k"], index["measure"],
                            device=str(device)).set_seed(seed % 2 ** 31)
    for call, kwargs in index["steps"].items():
        b = getattr(b, call)(**kwargs)
    return b.build()


def leaf_sizes(searcher) -> np.ndarray:
    """Rows in each leaf of the built partition."""
    tokens = np.asarray(searcher.datapoint_to_token).reshape(-1)
    return np.bincount(tokens[tokens >= 0],
                       minlength=searcher.partitioner.num_leaves)


def leaf_lists(searcher, queries, leaves: int):
    """(leaf ids (nq, L), searched mask (nq, L)) that the partition gives
    a batch of float32 queries (numpy), as numpy arrays."""
    part = searcher.partitioner
    q = torch.as_tensor(queries, device=part.centers.device)
    ids, keep, _ = part.select_leaves(q, min(leaves, part.num_leaves))
    return ids.cpu().numpy(), keep.cpu().numpy()
