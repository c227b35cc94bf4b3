"""Faults planted under the timed path, to show that the check sees them.

Each wraps the program's searcher and breaks what its answers say, where
they are produced; the window and the check run unchanged on top.  A
search cell on one chip can have these two faults:

  half_batch      half of each batch left out: its second half answered
                  with the first half's answers
  answer_altered  one answer of each batch altered: its nearest id
                  replaced by another row's
"""

from __future__ import annotations

import numpy as np


class _Altered:
    def __init__(self, pending, alter):
        self._pending, self._alter = pending, alter

    def result(self):
        ids, dist = self._pending.result()
        return self._alter(np.array(ids), np.array(dist))


def _half_batch(ids, dist):
    h = len(ids) // 2
    ids[len(ids) - h:] = ids[:h]
    dist[len(ids) - h:] = dist[:h]
    return ids, dist


def _answer_altered(ids, dist):
    row = len(ids) // 3
    ids[row, 0] = (ids[row, 0] + 1) % (ids.max() + 1)
    return ids, dist


FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered}


class Faulty:
    """The searcher with one fault planted in its answers."""

    def __init__(self, searcher, fault: str):
        self._searcher = searcher
        self._alter = FAULTS[fault]

    def __getattr__(self, name):
        return getattr(self._searcher, name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._searcher, name, value)

    def search_batched_async(self, queries, **kw):
        return _Altered(self._searcher.search_batched_async(queries, **kw),
                        self._alter)
