"""What decides `correct`: every answer of the run against the reference.

Each answer is one query's (ids, distances) as the timed path returned
them.  The numbers compared, each against its cell's limit
(portbench/limits/<cell>.json):

  unanswered    queries sent whose answer never came (exact: limit 0)
  bad_rows      answers with an id out of range, an id twice, a
                non-finite distance, fewer than k results, or not best
                first (exact: limit 0)
  recall_short  1 - recall@k of every answer against the exact top k
  dist_gap      the widest gap between a returned distance and the float64
                distance of the returned id, in units of the numbers it
                is computed from (|q| |x|, or |q|^2 + |x|^2)

The first two are exact; the last two have limits set from readings of
sound runs and of the control (reference/control.py) and the faults
(harness/faults.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact_knn

CHUNK = 65536
NAMES = ("unanswered", "bad_rows", "recall_short", "dist_gap")


def bad_rows(ids: np.ndarray, dist: np.ndarray, n: int, k: int,
             nearer_larger: bool) -> np.ndarray:
    """(N,) bool: rows that break the answer's form."""
    bad = (ids.shape[1] < k) | np.zeros(len(ids), bool)
    bad |= ((ids < 0) | (ids >= n)).any(1)
    bad |= ~np.isfinite(dist).all(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    step = np.diff(dist, axis=1)
    with np.errstate(invalid="ignore"):
        bad |= ((step > 0) if nearer_larger else (step < 0)).any(1)
    return bad


def judge(rows, pool, truth_ids, qidx, ids, dist, in_window, measure: str,
          k: int, unanswered: int, limits: dict) -> dict:
    """The compared numbers, recall@k in the window, and the failures.

    rows (n, d) and pool (P, d): float32 tensors on the reference's
    device; truth_ids (P, k) tensor; qidx (N,) numpy pool rows of the
    answers; ids (N, k), dist (N, k) numpy; in_window (N,) bool."""
    dev = rows.device
    n = rows.shape[0]
    ids = np.asarray(ids).astype(np.int64, copy=False)
    dist = np.asarray(dist)
    bad = bad_rows(ids, dist, n, k, exact_knn.larger_is_nearer(measure))
    hits_all = hits_win = 0
    gap = 0.0
    for i in range(0, len(ids), CHUNK):
        sl = slice(i, i + CHUNK)
        q_i = torch.as_tensor(qidx[sl], device=dev)
        got = torch.as_tensor(ids[sl], device=dev)
        good = torch.as_tensor(~bad[sl], device=dev)
        got_safe = torch.clamp(got, 0, n - 1)
        want = truth_ids[q_i]
        h = (got_safe[:, :, None] == want[:, None, :]).any(2)
        h = (h & (got >= 0) & (got < n)).sum(1)
        hits_all += int(h.sum())
        hits_win += int(h[torch.as_tensor(in_window[sl], device=dev)].sum())
        q = pool[q_i]
        ref = exact_knn.distances64(rows, q, got_safe, measure)
        scale = exact_knn.scale64(rows, q, got_safe, measure)
        d = torch.as_tensor(dist[sl], device=dev).double()
        g = ((d - ref).abs() / torch.clamp_min(scale, 1e-30)).amax(1)
        g = torch.where(good, g, torch.zeros_like(g))
        if g.numel():
            gap = max(gap, float(g.max()))
    n_ans = len(ids)
    n_win = int(np.count_nonzero(in_window))
    numbers = {
        "unanswered": unanswered,
        "bad_rows": int(bad.sum()),
        "recall_short": 1.0 - hits_all / max(n_ans * k, 1),
        "dist_gap": gap,
    }
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in NAMES}
    return {
        "checks": checks,
        "correct": all(c["value"] <= c["limit"] for c in checks.values())
        and n_ans > 0,
        "failed": unanswered + int(bad.sum()),
        "recall_in_window": hits_win / max(n_win * k, 1),
    }


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
