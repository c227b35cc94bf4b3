"""The program's host spans in one traced window of a cell: what each layer
costs the host a batch, against the benchmark's own traced numbers.

    python3 portbench/tools/span_breakdown.py --workload <cell> --seed <n> \
        --spans 1 [--seconds 10] [--cost-batches 400]

Sets the cell up as portbench/run.py does (corpus, build, warm-up), with
the program's spans on (``--spans 1``, from before the build) or off,
profiles the window as a ``--trace 1`` run does, and prints one JSON line:
the benchmark's traced numbers (``qps``, ``dispatch_ms.batch``,
``build_s``, ``setup_s``, the device ms by stage, the idle share and the
idle gaps), the span numbers of harness/spans.py (host ms a batch by
layer, the entry's rest, the dispatch's waits on the card, the result
copy, and the set-up seconds of partition, quantize, layout and
register), the build's phases against ``build_s``, the host spans against
the dispatch time, and which of trace.summarize's numbers read otherwise
with the program's spans taken out of the trace (none should).  With
``--cost-batches n``, the spans' cost besides: n more batches two deep
with spans on for every other one, once untraced and once under the
profiler, and the mean dispatch ms of the batches with spans on and of
those with spans off (one process, one searcher: no process-to-process
noise).  One process a run: the custom ops register once a process.  The
answers are not checked.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _differing(a, b) -> list:
    """The keys of trace.summarize's numbers that differ, the idle gaps
    aside: their names may name program spans, which splits a gap's
    seconds over more names, and the top ten then hold other gaps."""
    if a is None or b is None:
        return [] if a is b else ["all"]
    return [k for k in a if k != "idle_gaps" and a[k] != b[k]]


def _counted_dispatch_ms(events, settle_s: float) -> list:
    """Host ms of each ``portbench.dispatch`` that trace.summarize counts:
    on the traced span's thread, started in it after its settling part."""
    span = next(e for e in events if e.get("name") == "portbench.traced"
                and e.get("cat") == "user_annotation")
    t0 = float(span["ts"]) + settle_s * 1e6
    t1 = float(span["ts"]) + float(span["dur"])
    return [1e-3 * float(e["dur"]) for e in events
            if e.get("name") == "portbench.dispatch"
            and e.get("cat") == "user_annotation"
            and e["tid"] == span["tid"] and t0 <= float(e["ts"]) <= t1]


def span_cost(searcher, batches, kw, n: int, traced: bool, device) -> dict:
    """Mean dispatch ms of n batches, two in flight as the batch driver
    keeps them, with the spans on for every other batch."""
    import collections
    import contextlib
    import torch
    from scann_torch.utils import profiling
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    times = {True: [], False: []}
    inflight = collections.deque()
    was = profiling.spans_enabled()
    with (torch.profiler.profile(activities=acts) if traced
          else contextlib.nullcontext()):
        for i in range(n):
            on = i % 2 == 0
            profiling.enable_spans(on)
            t = time.perf_counter()
            inflight.append(searcher.search_batched_async(
                batches[i % len(batches)], **kw))
            times[on].append(time.perf_counter() - t)
            if len(inflight) == 2:
                inflight.popleft().result()
        while inflight:
            inflight.popleft().result()
    profiling.enable_spans(was)
    on, off = (1e3 * sum(times[k]) / len(times[k]) for k in (True, False))
    return {"on_ms": on, "off_ms": off, "on_less_off_ms": on - off}


def run(workload: str, seed: int, seconds: float, spans_on: bool,
        device="cuda", config=None, traffic=None, t_start=None,
        cost_batches=0) -> dict:
    import torch
    from portbench.harness import core, program, spans, spec, trace
    from scann_torch.utils import profiling

    t_start = T_START if t_start is None else t_start
    profiling.enable_spans(spans_on)
    profiling.reset_span_totals()
    bench_spec = spec.load_benchmark()
    cell = spec.find(bench_spec["workloads"], workload, "workload")
    config = config or spec.load_config(bench_spec, cell["config"])
    traffic = traffic or spec.load_traffic(cell["traffic"])
    dev = torch.device(device)
    index = config["index"]
    corpus = spec.module("corpora", config["corpus"]["generator"])
    pool_n = traffic["batch"] * traffic["pool_batches"]
    rows_d, pool_d = corpus.make(config["corpus"], seed, pool_n, dev)
    rows, pool = rows_d.cpu().numpy(), pool_d.cpu().numpy()
    del rows_d, pool_d
    t = time.perf_counter()
    searcher = program.build(index, rows, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    built = profiling.span_totals()

    class Bench(core.Bench):
        def window_starts(self):
            self.setup_totals = profiling.span_totals()
            super().window_starts()

    tmp = tempfile.mkdtemp(prefix="portbench_spans_")
    bench = Bench(searcher, pool, config.get("search", {}), index["k"],
                  seed, dev, True, tmp, core._log,
                  min(core.TRACE_S, 0.5 * seconds),
                  min(core.SETTLE_S, 0.2 * seconds))
    driver = spec.module("drivers", traffic["driver"])
    window = driver.run(bench, traffic, seconds)
    summary = bench.tracer.export()
    with open(bench.tracer.path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(tmp, ignore_errors=True)
    settle = bench.tracer.settle_s
    host = spans.summarize(events, settle) or {}
    plain = trace.summarize([e for e in events if not str(
        e.get("name", "")).startswith(spans.PREFIX)], settle)
    counted = summary["stage_batches"]
    traced = _counted_dispatch_ms(events, settle)
    out = {
        "workload": workload, "seed": seed, "spans": int(spans_on),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "power_limit": core.power_limit() if dev.type == "cuda" else None,
        "qps": window.completed / window.seconds,
        "dispatch_ms.batch": 1e3 * sum(window.dispatch_s)
        / max(len(window.dispatch_s), 1),
        "traced_dispatch_ms": (sum(traced) / len(traced)
                               if traced else None),
        "build_s": build_s, "setup_s": window.start - t_start,
        "build_spans_s": {k: v[0] for k, v in built.items()},
        "stage_device_ms": {k: 1e3 * v / len(counted)
                            for k, v in summary["stage_s"].items()}
        if counted else {},
        "device_idle": 100.0 * (1 - summary["busy_s"] / summary["window_s"]),
        "idle_gaps": summary["idle_gaps"],
        "launches": summary["launches"],
        "host": host,
        "setup_spans_s": spans.setup_seconds(
            getattr(bench, "setup_totals", None)),
        "summarize_differs_without_spans": _differing(summary, plain),
    }
    phases = [built[k][0] for k in ("partition", "quantize", "layout")
              if k in built]
    if phases:
        out["build_phases_gap_pct"] = 100.0 * (build_s - sum(phases)) \
            / build_s
    if host:
        layers = sum(host[f"{s}_host_ms"] for s in spans.LAYER_STAGES) \
            + host["entry_host_ms.batch"]
        out["host_layers_ms"] = layers
        out["host_gap_pct"] = 100.0 * (out["dispatch_ms.batch"] - layers) \
            / out["dispatch_ms.batch"]
        if traced:
            out["host_gap_traced_pct"] = 100.0 * (
                out["traced_dispatch_ms"] - layers) / out["traced_dispatch_ms"]
    if cost_batches:
        batches = [pool[i:i + traffic["batch"]]
                   for i in range(0, len(pool), traffic["batch"])]
        out["span_cost"] = {
            "untraced": span_cost(searcher, batches, config.get("search", {}),
                                  cost_batches, False, dev),
            "traced": span_cost(searcher, batches, config.get("search", {}),
                                cost_batches, True, dev)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cost-batches", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         bool(args.spans), args.device,
                         cost_batches=args.cost_batches)), flush=True)


if __name__ == "__main__":
    main()
