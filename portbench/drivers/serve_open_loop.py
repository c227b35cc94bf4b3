"""Single queries on an open-loop Poisson schedule into the program's
in-process micro-batcher, ``serving.SearchService`` (no HTTP).

Traffic parameters: ``rate_qps`` (the offered rate), ``max_batch`` and
``max_wait_ms`` (the service's), ``pool_queries`` (the distinct seeded
queries the schedule cycles through).  Arrivals are drawn from the seed:
independent users, so the schedule does not wait for answers and the
backlog can grow.  Each request is timed from the moment it was due, so a
stall also delays every request behind it, and it reports how
late it sent them.  After the window closes no more are sent; each one
sent is waited for, up to a minute past the close.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness.window import Window

DRAIN_S = 60.0
WARMUP_S = 1.0


def _percentiles(x, ps=(50, 95, 99)):
    if len(x) == 0:
        return {}
    return {f"p{p}_ms": float(np.percentile(x, p) * 1e3) for p in ps}


def _offer(svc, pool, due, t0, deadline, done_t, tick=lambda: None):
    """Submit pool[i % len(pool)] at t0 + due[i], recording in done_t[i]
    when its answer comes; returns (futures, the lateness of each
    submission)."""

    def on_done(i):
        def _cb(_f):
            done_t[i] = time.perf_counter()
        return _cb

    futs, late = [], np.zeros(len(due))
    for i, d in enumerate(due):
        t_due = t0 + d
        if t_due > deadline:
            late = late[:i]
            break
        wait = t_due - time.perf_counter()
        if wait > 0:
            # Sleep, never spin: a spinning thread holds the interpreter
            # lock that the service thread needs to dispatch.
            time.sleep(wait)
        late[i] = time.perf_counter() - t_due
        f = svc.submit(pool[i % len(pool)])
        f.add_done_callback(on_done(i))
        futs.append(f)
        tick()
    return futs, late


def run(bench, params: dict, seconds: float) -> Window:
    from scann_torch import serving

    rate = float(params["rate_qps"])
    pool = bench.pool
    k = bench.k
    rng = np.random.default_rng(bench.seed)
    span = seconds + WARMUP_S
    n = int(rate * span * 1.2) + 16
    due = np.cumsum(rng.exponential(1.0 / rate, n))

    svc = serving.SearchService(bench.searcher,
                                max_batch=int(params["max_batch"]),
                                max_wait_ms=float(params["max_wait_ms"]),
                                **bench.search_kwargs)
    with svc:
        # Warm-up: every micro-batch width the rate makes, on the same
        # schedule, before the window.
        t0 = time.perf_counter()
        warm, _ = _offer(svc, pool, due, t0, t0 + WARMUP_S,
                         np.full(n, np.nan))
        for f in warm:
            f.result(timeout=DRAIN_S)
        rest = due[len(warm):] - due[len(warm)]
        done = np.full(len(rest), np.nan)
        svc.batches = svc.queries = 0
        bench.window_starts()
        start = time.perf_counter()
        end = start + seconds
        futs, late = _offer(svc, pool, rest, start, end, done,
                            bench.after_batch)
        drain_until = end + DRAIN_S
        answers, unanswered = [], 0
        for j, f in enumerate(futs):
            try:
                ids, dist = f.result(timeout=max(drain_until
                                                 - time.perf_counter(), 0))
                answers.append((j, ids, dist))
            except Exception as e:          # an answer that never comes
                unanswered += 1
                if unanswered == 1:
                    bench.log(f"request {j} failed: {e!r}")
        batches, queries = svc.batches, svc.queries
    done = done[:len(futs)]
    lat = done - (start + rest[:len(futs)])
    inside = done <= end
    idx = [j for j, _, _ in answers]
    qidx = np.asarray(idx, np.int64) % len(pool)
    ids = np.asarray([a[1] for a in answers]).reshape(-1, k)
    dist = np.asarray([a[2] for a in answers]).reshape(-1, k)
    backlog_end = int(np.count_nonzero(~(done <= end)))
    info = {"offered_qps": rate, "sent": len(futs),
            "completed_in_window": int(np.count_nonzero(inside)),
            "backlog_at_close": backlog_end,
            "latency_from_due": _percentiles(lat[np.isfinite(lat)]),
            "generator_late": _percentiles(late),
            "mean_micro_batch": queries / max(batches, 1),
            "micro_batches": batches}
    return Window(seconds=seconds, start=start, attempted=len(futs),
                  completed=int(np.count_nonzero(inside)),
                  unanswered=unanswered, qidx=qidx, ids=ids, dist=dist,
                  in_window=inside[idx] if idx else np.zeros(0, bool),
                  info=info)
