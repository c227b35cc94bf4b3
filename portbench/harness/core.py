"""One run of one cell: set-up, the measured window, the check, the line.

    set-up    the corpus and the query pool on the device from the seed,
              copied to host numpy (what a user hands the program); the
              index build; the traffic driver's warm-up
    window    the traffic driver, for ``seconds``; with ``trace`` a
              profiler span of it, with the program's stage marks in it
    close     peak memory; no JAX module may be loaded; the traced
              numbers; the program's state freed
    check     the reference's exact top k of the pool, and every answer
              of the run judged against it (harness/check.py)

The metrics are read by portbench/metrics/<name>.py from a ``Run``.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.harness import check, faults, peaks, program, spec
from portbench.harness.trace import Tracer, mark
from portbench.reference import control, exact_knn

BANNED = ("jax", "jaxlib", "flax", "scann_tpu")
TRACE_S = 1.5          # profiled seconds of a traced window
SETTLE_S = 0.5         # ... after this much of it


def banned_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""
    config: dict
    traffic: dict
    window: object = None
    rows: int = 0
    setup_s: float | None = None
    build_s: float | None = None
    index_bytes: int | None = None
    recall_in_window: float | None = None
    stage_ms: dict | None = None        # device ms a batch, by stage
    score_least_ms: float | None = None  # least ms of a batch's scoring
    trace: dict | None = None


class Bench:
    """What a driver sees: the searcher, the query pool (host numpy), the
    search parameters, and the hooks around the window."""

    def __init__(self, searcher, pool, search_kwargs, k, seed, device,
                 trace, trace_dir, log, trace_seconds=TRACE_S,
                 settle_s=SETTLE_S):
        self.searcher, self.pool = searcher, pool
        self.search_kwargs, self.k, self.seed = search_kwargs, k, seed
        self.device, self.trace, self.trace_dir = device, trace, trace_dir
        self.log = log
        self.trace_seconds, self.settle_s = trace_seconds, settle_s
        self.tracer = None
        self.index_bytes = None

    def window_starts(self):
        """Called by the traffic driver after its warm-up, just before its
        window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.index_bytes = torch.cuda.memory_allocated()
        if self.trace:
            self.searcher.stage_hook = mark
            self.tracer = Tracer(self.device, self.trace_dir,
                                 self.trace_seconds, self.settle_s)
            self.tracer.start()

    def after_batch(self):
        if self.tracer is not None:
            self.tracer.tick()


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", variant: str | None = None, t_start=None,
             config=None, traffic=None, limits=None, log=_log) -> dict:
    """The result line's object, with the lines to print before it under
    ``"_info"``.  ``variant``: None (the program), "control" (the
    reference in its place, one precision down) or a fault of
    harness/faults.py planted in the program's answers.  ``config``,
    ``traffic`` and ``limits`` stand in for the cell's files."""
    t_entry = time.perf_counter()
    t_start = t_entry if t_start is None else t_start
    bench_spec = spec.load_benchmark()
    cell = spec.find(bench_spec["workloads"], workload, "workload")
    config = config or spec.load_config(bench_spec, cell["config"])
    traffic = traffic or spec.load_traffic(cell["traffic"])
    limits = limits or spec.load_limits(workload)
    dev = torch.device(device)
    index = config["index"]
    k, measure = index["k"], index["measure"]
    pool_n = traffic.get("pool_queries",
                         traffic.get("batch", 0) * traffic.get(
                             "pool_batches", 0))

    corpus = spec.module("corpora", config["corpus"]["generator"])
    rows_d, pool_d = corpus.make(config["corpus"], seed, pool_n, dev)
    rows, pool = rows_d.cpu().numpy(), pool_d.cpu().numpy()
    del rows_d, pool_d
    t_corpus = time.perf_counter()
    run = Run(config=config, traffic=traffic, rows=len(rows))
    if variant == "control":
        searcher = control.ControlSearcher(torch.as_tensor(rows, device=dev),
                                           k, measure)
    else:
        t = time.perf_counter()
        searcher = program.build(index, rows, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        run.build_s = time.perf_counter() - t
        if variant is not None:
            searcher = faults.Faulty(searcher, variant)
    search_kwargs = config.get("search", {})
    tmp = tempfile.mkdtemp(prefix="portbench_")
    bench = Bench(searcher, pool, search_kwargs, k, seed, dev, trace, tmp,
                  log, min(TRACE_S, 0.5 * seconds),
                  min(SETTLE_S, 0.2 * seconds))
    driver = spec.module("drivers", traffic["driver"])
    t_built = time.perf_counter()
    window = driver.run(bench, traffic, seconds)

    # The window has closed.
    run.window = window
    run.setup_s = window.start - t_start
    run.index_bytes = bench.index_bytes
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    found = banned_modules()
    if found:
        raise RuntimeError(f"modules the run may not load: {found}")
    info = {"window": window.info, "build_s": run.build_s,
            "index_bytes": run.index_bytes,
            "setup_parts_s": {"start": t_entry - t_start,
                              "corpus": t_corpus - t_entry,
                              "build": t_built - t_corpus,
                              "warmup": window.start - t_built}}
    if trace:
        run.trace = bench.tracer.export() if bench.tracer else None
        if run.trace is not None:
            counted = run.trace["stage_batches"]
            run.stage_ms = ({s: 1e3 * v / len(counted)
                             for s, v in run.trace["stage_s"].items()}
                            if counted else {})
            slots = [window.slots[i] for i in counted
                     if i < len(window.slots)]
            if (variant != "control" and "score_work" in config
                    and "batch" in traffic and slots):
                run.score_least_ms, info["work"] = _score_work(
                    searcher, config, search_kwargs, pool, traffic, slots)
            info["stage_device_ms_per_batch"] = run.stage_ms
            info["launches_per_batch"] = run.trace["launches"]
            info["traced_window_s"] = run.trace["window_s"]
            info["traced_batches"] = run.trace["batches"]
    shutil.rmtree(tmp, ignore_errors=True)
    bench.searcher = searcher = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    rows_t = torch.as_tensor(rows, device=dev)
    pool_t = torch.as_tensor(pool, device=dev)
    truth, _ = exact_knn.exact_top_k(rows_t, pool_t, k, measure)
    verdict = check.judge(rows_t, pool_t, truth, window.qidx, window.ids,
                          window.dist, window.in_window, measure, k,
                          window.unanswered, limits)
    info["check_s"] = time.perf_counter() - t
    run.recall_in_window = verdict["recall_in_window"]

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench_spec, workload, section):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": int(mem_peak)}
    if dev.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result = {"correct": verdict["correct"], "attempted": window.attempted,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev_info}
    if trace and run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace["device_ops"]],
            "idle_gaps": [list(x) for x in run.trace["idle_gaps"]]}
    result["checks"] = verdict["checks"]
    result["_info"] = info
    return result


def _score_work(searcher, config, search_kwargs, pool, traffic, slots):
    """(least ms of the scoring work of a batch, averaged over the pool
    batches of ``slots``, a summary): each pool batch's work counted once
    from its leaf lists."""
    index = config["index"]
    steps = index["steps"]
    leaves = search_kwargs.get("leaves_to_search",
                               steps["tree"]["num_leaves_to_search"])
    k_pre = search_kwargs.get(
        "pre_reorder_num_neighbors",
        steps.get("reorder", {}).get("reordering_num_neighbors",
                                     index["k"]))
    count = spec.module("work", config["score_work"]).count
    sizes = program.leaf_sizes(searcher)
    batch = traffic["batch"]
    least, pairs = {}, {}
    for slot in sorted(set(slots)):
        q = pool[slot * batch:(slot + 1) * batch]
        ids, keep = program.leaf_lists(searcher, q, leaves)
        w = count(ids, keep, sizes, len(q), q.shape[1], k_pre, index)
        least[slot] = peaks.least_seconds(w)
        pairs[slot] = w["pairs"]
    least_ms = 1e3 * float(np.mean([least[s] for s in slots]))
    return least_ms, {"least_ms_per_batch": least_ms,
                      "pairs_per_batch": float(np.mean([pairs[s]
                                                        for s in slots]))}
