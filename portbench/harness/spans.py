"""The program's host spans (scann_torch/utils/profiling.py) in a traced
window, reduced to per-layer numbers.

It reads the chrome trace that ``Tracer.export`` writes, over the same
part of it and the same batches as ``trace.summarize``: the dispatches
that start inside the ``portbench.traced`` span after its settling part.
In each such dispatch, the outermost ``scann_torch.search`` span (a split
search nests its sub-batches in it) gives, in ms a batch over those
batches:

  <stage>_host_ms          host ms of the stage's span less the program
                           spans nested in it (a first use's ``register``
                           or ``layout``), for the stages of the five
                           layers: tokenize, plan, score, merge, reorder
  entry_host_ms.batch      the search span less its stage spans (``scan``,
                           the dense paths' stage, is one of them):
                           checks, the query upload, ``finish``, a split's
                           bookkeeping
  dispatch_wait_ms.batch   host ms of the blocking runtime calls inside the
                           search spans: the time the dispatch waits on
                           the card (``dispatch_wait_ms_by_span``: split
                           by the innermost program span and host
                           operation around each call, "<span>/<op>")
  result_host_ms.batch     the ``result`` span of each of those batches
                           found in the trace (by its batch id), averaged
                           over those found

and, from ``span_totals()`` taken at the window's start, the set-up
seconds of ``partition``, ``quantize``, ``layout`` (the build's and a
first search's lazy pruned layout) and ``register`` as ``<name>_s``.

A program without spans gives no number (``summarize`` returns None, and
the totals hold none of the names): a metric read from here is then left
out of the result line.
"""

from __future__ import annotations

import json
import os

PREFIX = "scann_torch."
BATCH_TAG = PREFIX + "batch."
LAYER_STAGES = ("tokenize", "plan", "score", "merge", "reorder")
STAGES = LAYER_STAGES + ("scan",)
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpy")
SETUP = ("partition", "quantize", "layout", "register")
# The program's ranges are cpu_op events (RecordFunctionFast); a
# record_function range would be a user_annotation.
PROGRAM_CATS = ("cpu_op", "user_annotation")


def _x(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]


def _within(items, a, b):
    return [x for x in items if a <= x[0] and x[1] <= b]


def _self_us(span, spans):
    """The span's duration less the outermost program spans inside it."""
    a, b, _ = span
    inner = [s for s in _within(spans, a, b) if s is not span]
    top = [s for s in inner
           if not any(o is not s and o[0] <= s[0] and s[1] <= o[1]
                      for o in inner)]
    return (b - a) - sum(s[1] - s[0] for s in top)


def _tag(items, span):
    tags = [x[2] for x in _within(items, span[0], span[1])
            if x[2].startswith(BATCH_TAG)]
    return tags[0] if tags else None


def summarize(events: list, settle_s: float = 0.0) -> dict | None:
    """The host numbers of a chrome trace's program spans (ts and dur in
    microseconds) in the batches that ``trace.summarize`` counts; None
    without a ``portbench.traced`` span, without a counted batch, or when
    a counted batch holds no ``scann_torch.search`` span."""
    ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = [e for e in ev if e.get("name") == "portbench.traced"
            and e.get("cat") == "user_annotation"]
    if not span:
        return None
    tid = span[0]["tid"]
    t_span, t1, _ = _x(span[0])
    t0 = t_span + settle_s * 1e6
    mine = [e for e in ev if e["tid"] == tid]
    dispatches = sorted(_x(e) for e in mine
                        if e.get("cat") == "user_annotation"
                        and e["name"] == "portbench.dispatch")
    counted = [d for d in dispatches if t0 <= d[0] <= t1]
    program = sorted(_x(e) for e in mine if e.get("cat") in PROGRAM_CATS
                     and e["name"].startswith(PREFIX))
    tags = [p for p in program if p[2].startswith(BATCH_TAG)]
    spans = [p for p in program if not p[2].startswith(BATCH_TAG)]
    blocking = [_x(e) for e in mine if e.get("cat") == "cuda_runtime"
                and e["name"] in BLOCKING]
    ops = [_x(e) for e in mine if e.get("cat") == "cpu_op"
           and not e["name"].startswith(PREFIX)]
    if not counted:
        return None
    stage_us = {s: 0.0 for s in LAYER_STAGES}
    entry_us = wait_us = 0.0
    wait_by: dict = {}
    batch_tags = set()
    for d in counted:
        searches = [s for s in _within(spans, d[0], d[1])
                    if s[2] == PREFIX + "search"]
        if not searches:
            return None
        search = min(searches, key=lambda s: (s[0], -s[1]))
        inside = _within(spans, search[0], search[1])
        staged = 0.0
        for s in inside:
            name = s[2][len(PREFIX):]
            if name in STAGES:
                staged += s[1] - s[0]
                if name in stage_us:
                    stage_us[name] += _self_us(s, spans)
        entry_us += (search[1] - search[0]) - staged
        for a, b, _ in _within(blocking, search[0], search[1]):
            wait_us += b - a
            around = min((s for s in inside if s[0] <= a and b <= s[1]),
                         key=lambda s: s[1] - s[0], default=search)
            op = min((o for o in _within(ops, around[0], around[1])
                      if o[0] <= a and b <= o[1]),
                     key=lambda o: o[1] - o[0], default=(0, 0, "python"))
            name = f"{around[2][len(PREFIX):]}/{op[2]}"
            wait_by[name] = wait_by.get(name, 0.0) + b - a
        batch_tags.add(_tag(tags, search))
    results = [r for r in spans if r[2] == PREFIX + "result"
               and _tag(tags, r) in batch_tags]
    n = len(counted)
    out = {f"{s}_host_ms": 1e-3 * v / n for s, v in stage_us.items()}
    out["entry_host_ms.batch"] = 1e-3 * entry_us / n
    out["dispatch_wait_ms.batch"] = 1e-3 * wait_us / n
    out["dispatch_wait_ms_by_span"] = {k: 1e-3 * v / n
                                       for k, v in sorted(wait_by.items())}
    if results:
        out["result_host_ms.batch"] = 1e-3 * sum(
            b - a for a, b, _ in results) / len(results)
    out["batches"] = n
    return out


def setup_seconds(totals: dict | None) -> dict:
    """{"<name>_s": seconds} of the set-up spans in ``span_totals()``
    ({name: (seconds, count)})."""
    return {f"{name}_s": float(totals[name][0])
            for name in SETUP if totals and name in totals}


def read(path: str, settle_s: float = 0.0) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    return summarize(data.get("traceEvents", []), settle_s)
