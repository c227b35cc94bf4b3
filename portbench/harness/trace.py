"""A torch.profiler span of a window, reduced to numbers.

The tracer starts before the window, and the traffic driver's tick after each
batch (or request) stops it once its seconds are over; the chrome trace
goes under TMPDIR.  ``summarize`` reads the span less its first settling
part:

  window_s      the length of what is read
  busy_s        the union of kernel, memcpy and memset intervals in it
  device_ops    device time by operation name (top 10)
  idle_gaps     idle device time by what the host was doing in the
                middle of each gap: the benchmark's annotation
                (``portbench.dispatch`` / ``portbench.result``) and the
                innermost host operation of the thread that ran the most
                of them (top 10)
  launches      kernel launches, copies and memsets a batch, by the
                program's stage (the launches before each ``stage.<name>``
                mark), and in the result copy
  stage_s       device seconds of each stage, summed over the batches
                dispatched inside what is read: the union of the kernel,
                copy and memset intervals whose launch (found by its
                correlation id) falls in that stage; host-to-device copies
                are the search entry's ``upload``
  stage_batches the indices, among the span's dispatches, of those batches

The program's stage marks are the zero-length annotations that ``mark``
leaves when it is the searcher's ``stage_hook``.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UPLOAD = "Memcpy HtoD"     # the name of a host-to-device copy starts so
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset")
TOP = 10
NAME_CHARS = 96


def mark(name: str):
    """The program's stage hook in a traced run: a zero-length profiler
    annotation ``stage.<name>`` after the stage's work is enqueued."""
    with torch.profiler.record_function(f"stage.{name}"):
        pass


class Tracer:
    """Profiles from ``start()`` until ``settle_s + seconds`` later (the
    first ``tick()`` after that stops it); ``export()`` writes the trace.
    The traced span is one ``portbench.traced`` annotation; its first
    ``settle_s`` are left out of the numbers.  It ends once the device has
    finished what was enqueued, so that every batch dispatched inside it
    has all of its device work in the trace."""

    def __init__(self, device, out_dir: str, seconds: float,
                 settle_s: float):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = os.path.join(out_dir, "portbench_trace.json")
        self.seconds, self.settle_s = seconds, settle_s
        self.prof = torch.profiler.profile(activities=acts)
        self._span = None
        self.t_stop = None
        self.running = False

    def start(self):
        self.prof.start()
        self._span = torch.profiler.record_function("portbench.traced")
        self._span.__enter__()
        self.running = True
        self.t_stop = time.perf_counter() + self.settle_s + self.seconds

    def tick(self):
        if self.running and time.perf_counter() >= self.t_stop:
            self.stop()

    def stop(self):
        if self.running:
            if self.cuda:
                torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self.prof.stop()
            self.running = False

    def export(self) -> dict | None:
        self.stop()
        self.prof.export_chrome_trace(self.path)
        return read(self.path, self.settle_s)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(starts, events, t, limit=4000):
    """Name of the innermost host event containing time t (events sorted
    by start, nested on one thread), or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and limit > 0:
        a, b, name = events[i]
        if b >= t:
            return name
        i -= 1
        limit -= 1
    return None


def summarize(events: list, settle_s: float = 0.0) -> dict | None:
    """Numbers of a chrome trace's complete ("X") events (ts and dur in
    microseconds) inside its ``portbench.traced`` span, less the span's
    first ``settle_s``; None when the trace holds no such span."""
    ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = [e for e in ev if e.get("name") == "portbench.traced"
            and e.get("cat") == "user_annotation"]
    if not span:
        return None
    tid = span[0]["tid"]
    t_span = float(span[0]["ts"])
    t0 = t_span + settle_s * 1e6
    t1 = t_span + float(span[0]["dur"])
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in ev if e["tid"] == tid
                 and e.get("cat") == "user_annotation"
                 and e["name"] in ("portbench.dispatch", "portbench.result"))
    all_disp = [a for a in ann
                if a[2] == "portbench.dispatch" and t_span <= a[0] <= t1]
    counted = [i for i, a in enumerate(all_disp) if a[0] >= t0]
    dispatches = [all_disp[i] for i in counted]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in ev if e.get("cat") in DEVICE_CATS]
    dev = [d for d in dev if d[1] > t0 and d[0] < t1]
    busy = _union([(max(a, t0), min(b, t1)) for a, b, _ in dev])
    ops: dict = defaultdict(float)
    for a, b, name in dev:
        ops[name[:NAME_CHARS]] += (min(b, t1) - max(a, t0)) * 1e-6
    # What the host was doing: the thread that ran the most host
    # operations in the span (the one that dispatches the searches).
    per_tid: dict = defaultdict(int)
    for e in ev:
        if e.get("cat") == "cpu_op" and t0 <= float(e["ts"]) <= t1:
            per_tid[e["tid"]] += 1
    host_tid = max(per_tid, key=per_tid.get) if per_tid else tid
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in ev if e["tid"] == host_tid
                  and e.get("cat") in ("cpu_op", "cuda_runtime",
                                       "user_annotation")
                  and not e["name"].startswith(("portbench.", "stage.",
                                                "ProfilerStep")))
    starts = [h[0] for h in host]
    ann_starts = [x[0] for x in ann]
    gaps: dict = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        top = _innermost(ann_starts, ann, mid) or "outside_dispatch"
        inner = _innermost(starts, host, mid) or "python"
        gaps[f"{top}/{inner}"[:NAME_CHARS]] += (b - a) * 1e-6
    stage_of = _stage_locator(ev, tid, all_disp, counted)
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "batches": len(dispatches),
        "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:TOP],
        "launches": _launches(ev, stage_of, t1, len(dispatches)),
        "stage_s": _stage_seconds(ev, stage_of),
        "stage_batches": counted,
    }


def _stage_locator(ev, tid, all_disp, counted):
    """A function from a host time to (the dispatch's index among the
    span's dispatches, the stage): the stage mark that follows the time
    inside its dispatch ("dispatch" after the last mark, "result" outside
    any dispatch), or None before the first counted dispatch or for a
    dispatch that is not counted."""
    marks = sorted((float(e["ts"]), e["name"][len("stage."):])
                   for e in ev if e["tid"] == tid
                   and e["name"].startswith("stage."))
    mark_ts = [m[0] for m in marks]
    d_starts = [d[0] for d in all_disp]
    keep = set(counted)

    def stage_of(t):
        j = bisect.bisect_right(d_starts, t) - 1
        if j not in keep:
            return None
        a, b, _ = all_disp[j]
        if t > b:
            return j, "result"
        m = bisect.bisect_left(mark_ts, t)
        return j, (marks[m][1] if m < len(marks) and mark_ts[m] <= b
                   else "dispatch")

    return stage_of


def _launches(ev, stage_of, t1, batches) -> dict:
    """Launches a batch, by stage."""
    if not batches:
        return {}
    counts: dict = defaultdict(int)
    for e in ev:
        if e.get("cat") not in HOST_LAUNCH_CATS or e["name"] not in LAUNCHES:
            continue
        t = float(e["ts"])
        where = stage_of(t) if t <= t1 else None
        if where is not None:
            counts[where[1]] += 1
    return {k: v / batches for k, v in sorted(counts.items())}


def _stage_seconds(ev, stage_of) -> dict:
    """{stage: device seconds} of the counted batches: each device
    operation goes to the stage of the launch that its correlation id
    names; a stage's seconds are the union of its operations' intervals.
    The result copy, outside every dispatch, goes to no batch."""
    launched = {}
    for e in ev:
        if e.get("cat") in HOST_LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launched[c] = float(e["ts"])
    per_stage: dict = defaultdict(list)
    for e in ev:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        where = None if t is None else stage_of(t)
        if where is None or where[1] == "result":
            continue
        stage = "upload" if e["name"].startswith(UPLOAD) else where[1]
        a = float(e["ts"])
        per_stage[stage].append((a, a + float(e["dur"])))
    return {s: sum(b - a for a, b in _union(iv)) * 1e-6
            for s, iv in sorted(per_stage.items())}


def read(path: str, settle_s: float = 0.0) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    return summarize(data.get("traceEvents", []), settle_s)
