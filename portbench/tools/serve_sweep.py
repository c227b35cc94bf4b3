"""The serve driver's sweep: one index, single queries offered open loop
at rising rates to the program's in-process micro-batcher.

    python3 portbench/tools/serve_sweep.py --config glove100-ah \
        --seed 7 --rates 5000,10000,20000 --seconds 5

One JSON line a rate: the completed rate, the backlog at the window's
close, latency from each request's due time (p50 / p95 / p99), how late
the generator sent (p50 / p99), the service's mean micro-batch and the
check of every answer against the reference (with the limits of the
config's batch cell), all from an untraced window; then the device idle
share of a profiled span of a second, shorter window at the same rate
(stopping the profiler stalls the generator, so it never runs in the
first).  The knee is the highest rate whose backlog does not grow.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    import torch
    from portbench.harness import check, core, program, spec
    from portbench.harness.trace import Tracer
    from portbench.reference import exact_knn

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="glove100-ah")
    ap.add_argument("--traffic", default="serve")
    ap.add_argument("--limits", default="glove100-ah.batch10k")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    bench_spec = spec.load_benchmark()
    config = spec.load_config(bench_spec, args.config)
    traffic = spec.load_traffic(args.traffic)
    limits = spec.load_limits(args.limits)
    dev = torch.device(args.device)
    index = config["index"]
    corpus = spec.module("corpora", config["corpus"]["generator"])
    rows_t, pool_t = corpus.make(config["corpus"], args.seed,
                                 traffic["pool_queries"], dev)
    rows, pool = rows_t.cpu().numpy(), pool_t.cpu().numpy()
    searcher = program.build(index, rows, args.seed, dev)
    truth, _ = exact_knn.exact_top_k(rows_t, pool_t, index["k"],
                                     index["measure"])
    driver = spec.module("drivers", traffic["driver"])
    tmp = tempfile.mkdtemp(prefix="portbench_sweep_")

    class TracedBench(core.Bench):
        def window_starts(self):
            self.tracer = Tracer(self.device, self.trace_dir,
                                 core.TRACE_S, core.SETTLE_S)
            self.tracer.start()

    def window(cls, rate, seconds):
        bench = cls(searcher, pool, config.get("search", {}), index["k"],
                    args.seed, dev, False, tmp, core._log)
        return bench, driver.run(bench, dict(traffic, rate_qps=rate),
                                 seconds)

    for rate in (float(x) for x in args.rates.split(",")):
        _, w = window(core.Bench, rate, args.seconds)
        traced, _ = window(TracedBench, rate,
                           core.SETTLE_S + core.TRACE_S + 0.5)
        t = traced.tracer.export()
        v = check.judge(rows_t, pool_t, truth, w.qidx, w.ids, w.dist,
                        w.in_window, index["measure"], index["k"],
                        w.unanswered, limits)
        print(json.dumps({
            "offered_qps": rate, "completed_qps": w.completed / w.seconds,
            **{k: w.info[k] for k in ("sent", "backlog_at_close",
                                      "mean_micro_batch", "micro_batches",
                                      "latency_from_due", "generator_late")},
            "device_idle_pct": (100.0 * (1 - t["busy_s"] / t["window_s"])
                                if t and t["window_s"] > 0 else None),
            "idle_gaps": t["idle_gaps"][:4] if t else None,
            "correct": v["correct"], "checks": v["checks"]}), flush=True)


if __name__ == "__main__":
    main()
