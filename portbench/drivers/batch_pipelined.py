"""Batched queries, dispatched ``depth`` deep: the traffic of a retrieval
pipeline that sends large batches.

Traffic parameters: ``batch`` (queries a batch), ``pool_batches`` (the
distinct seeded batches the window cycles through, uploaded from host
numpy as a user's queries are), ``depth`` (batches in flight: batch i+1
is enqueued before batch i's ``result()``, as ``SearchService`` does).

A closed loop: the next batch goes out as soon as one comes back.  Every
batch is searched once before the window, and the pipeline filled; a
query is complete when its ids and distances are in host memory.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench.harness.window import Window, stack


def _batches(pool, batch):
    return [pool[i:i + batch] for i in range(0, len(pool), batch)]


def run(bench, params: dict, seconds: float) -> Window:
    s = bench.searcher
    kw = bench.search_kwargs
    depth = int(params["depth"])
    batches = _batches(bench.pool, int(params["batch"]))
    k = bench.k

    def drive(count=None, until=None, hooks=False):
        """Dispatch batches (cycling the pool) until ``count`` have gone
        out or the clock passes ``until``; then drain."""
        inflight = collections.deque()
        parts, slots, dispatch_s = [], [], []
        sent = done_in = unanswered = 0
        i = 0
        while True:
            if (count is None or i < count) and (
                    until is None or time.perf_counter() < until):
                slot = i % len(batches)
                i += 1
                t = time.perf_counter()
                with torch.profiler.record_function("portbench.dispatch"):
                    p = s.search_batched_async(batches[slot], **kw)
                dispatch_s.append(time.perf_counter() - t)
                slots.append(slot)
                sent += len(batches[slot])
                inflight.append((slot, p))
                if len(inflight) < depth:
                    continue
            elif not inflight:
                break
            slot, p = inflight.popleft()
            n = len(batches[slot])
            try:
                with torch.profiler.record_function("portbench.result"):
                    ids, dist = p.result()
            except Exception as e:          # an answer that never comes
                bench.log(f"batch of pool slot {slot} failed: {e!r}")
                unanswered += n
                continue
            finally:
                if hooks:
                    bench.after_batch()
            t_done = time.perf_counter()
            inside = until is None or t_done <= until
            done_in += n if inside else 0
            q0 = slot * len(batches[0])
            parts.append((np.arange(q0, q0 + n), np.asarray(ids),
                          np.asarray(dist), np.full(n, inside)))
        return parts, slots, dispatch_s, sent, done_in, unanswered

    warm_s = []
    for slot in range(len(batches)):     # every shape and batch, once
        t = time.perf_counter()
        s.search_batched_async(batches[slot], **kw).result()
        warm_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    drive(count=2 * depth)               # and the pipeline, filled twice
    period = (time.perf_counter() - t) / (2 * depth)
    bench.window_starts()
    start = time.perf_counter()
    parts, slots, dispatch_s, sent, done_in, unanswered = drive(
        until=start + seconds, hooks=True)
    qidx, ids, dist, in_window = stack(parts, k)
    return Window(seconds=seconds, start=start, attempted=sent,
                  completed=done_in, unanswered=unanswered, qidx=qidx,
                  ids=ids, dist=dist, in_window=in_window, slots=slots,
                  dispatch_s=dispatch_s,
                  info={"batches": len(slots), "batch_period_s": period,
                        "warmup_s": [round(x, 4) for x in warm_s]})
