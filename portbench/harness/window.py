"""What a driver hands back: the answers of a window and how it ran."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Window:
    seconds: float                  # the measured window's length
    start: float                    # perf_counter at its start
    attempted: int                  # queries sent, in and after the window
    completed: int                  # queries answered inside the window
    unanswered: int                 # queries sent whose answer never came
    qidx: np.ndarray                # (N,) pool row of each answer
    ids: np.ndarray                 # (N, k)
    dist: np.ndarray                # (N, k)
    in_window: np.ndarray           # (N,) answered inside the window
    slots: list = dataclasses.field(default_factory=list)   # pool batch
    dispatch_s: list = dataclasses.field(default_factory=list)
    info: dict = dataclasses.field(default_factory=dict)


def stack(parts: list, k: int):
    """(qidx, ids, dist, in_window) from [(qidx, ids, dist, in_window)]."""
    if not parts:
        return (np.zeros((0,), np.int64), np.zeros((0, k), np.int64),
                np.zeros((0, k), np.float32), np.zeros((0,), bool))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))
