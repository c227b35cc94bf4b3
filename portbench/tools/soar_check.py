"""A SOAR cell's index and answers against the plain reference of SOAR
(portbench/reference/soar.py), at the cell's size, under the cell's
traffic:

    python3 portbench/tools/soar_check.py --workload glove100-soar.batch10k \
        --seed 7 [--seconds 10]

It builds the cell's index through harness/program.py, runs the cell's
traffic driver (its warm-up, then the window), then searches every pool
batch once more, so that every pool query is answered at least once
whatever the window's length, and compares every answered row (the
window's and the pool pass's) with the reference, in blocks:

  assignment    the program's ``tokenize_database_soar`` against the
                reference's ``assign`` on the index's own centers:
                primaries equal but at float32 ties, secondaries equal on
                >= 99.9% of rows, every other one a near-tie of the SOAR
                loss (soar.compare_assignment); besides, the rows whose
                layout leaves differ from that assignment (the build caps
                leaf sizes)
  layout        secondary slots the build laid out (the program's
                ``tree_ah.secondary_slots``): one a row
  pool pass     pool queries the pool pass left unanswered: 0
  outside       returned ids in none of the query's searched leaves, by
                the reference's assignment and leaf choice (ties within
                1e-6 either way): 0; and by the layout's own leaves
  repeated      answers that name an id twice: 0
  dist_gap      the widest gap of a returned distance to the float64 one,
                over |q||x|: at most the cell's limit
  recall        recall@k of every answer against the leaf-restricted exact
                answer (soar.search) and against the global exact one
                (exact_knn): at least RECALL_LEAF_BAR and the cell's own
                recall limit

One JSON line with every number, its bar and ``ok``; the exit code is 0
only when every bar holds.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# recall@10 against the leaf-restricted exact answer: the reorder rescores
# 150 of 300 fetched AH candidates exactly, so what it misses are rows
# that the int8-LUT scores ranked below the 150th in the searched leaves.
RECALL_LEAF_BAR = 0.98
BLOCK = 65536


def run_check(config, traffic, limits, seed, seconds, device="cuda",
              log=print):
    import numpy as np
    import torch
    from scann_torch.models import tree_ah

    from portbench.harness import core, program, spec
    from portbench.reference import exact_knn, soar

    dev = torch.device(device)
    index = config["index"]
    k, measure = index["k"], index["measure"]
    tree = index["steps"]["tree"]
    lam = float(tree["soar_lambda"])
    leaves = config["search"]["leaves_to_search"]
    pool_n = traffic["batch"] * traffic["pool_batches"]
    t0 = time.perf_counter()
    corpus = spec.module("corpora", config["corpus"]["generator"])
    rows_d, pool_d = corpus.make(config["corpus"], seed, pool_n, dev)
    rows, pool = rows_d.cpu().numpy(), pool_d.cpu().numpy()
    del rows_d, pool_d
    slots_before = tree_ah.secondary_slots
    searcher = program.build(index, rows, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    secondary_slots = tree_ah.secondary_slots - slots_before
    bench = core.Bench(searcher, pool, config["search"], k, seed, dev,
                       False, None, log)
    window = spec.module("drivers", traffic["driver"]).run(
        bench, traffic, seconds)
    qidx, ids_all, dist_all = [window.qidx], [window.ids], [window.dist]
    batch = traffic["batch"]
    pool_answered = 0
    for i in range(0, pool_n, batch):
        ids, dist = searcher.search_batched_async(
            pool[i:i + batch], **config["search"]).result()
        qidx.append(np.arange(i, i + len(ids)))
        ids_all.append(np.asarray(ids))
        dist_all.append(np.asarray(dist))
        pool_answered += len(ids)
    qidx, ids_all, dist_all = (np.concatenate(x)
                               for x in (qidx, ids_all, dist_all))
    rows_t = torch.as_tensor(rows, device=dev)
    pool_t = torch.as_tensor(pool, device=dev)
    part = searcher.partitioner
    centers = part.centers.clone()
    got = part.tokenize_database_soar(rows_t, searcher.part_cfg.soar)
    layout = torch.as_tensor(np.asarray(searcher.datapoint_to_token),
                             device=dev).long()
    bench.searcher = searcher = part = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    assignment = soar.assign(rows_t, centers, lam)
    report = {"assignment": soar.compare_assignment(rows_t, centers, lam,
                                                    got)}
    report["assignment"]["layout_moved"] = int(
        (layout != got.long()).any(1).sum())
    leaf_truth, _ = soar.search(rows_t, pool_t, centers, assignment,
                                leaves, k)
    truth, _ = exact_knn.exact_top_k(rows_t, pool_t, k, measure)
    outside = outside_layout = repeated = 0
    hits_leaf = hits_all = 0
    gap = 0.0
    n = len(ids_all)
    for i in range(0, n, BLOCK):
        qi = torch.as_tensor(qidx[i:i + BLOCK], device=dev)
        ids = torch.as_tensor(ids_all[i:i + BLOCK], device=dev).long()
        q = pool_t[qi]
        outside += soar.outside_searched(ids, q, centers, assignment,
                                         leaves)
        outside_layout += soar.outside_searched(ids, q, centers, layout,
                                                leaves)
        repeated += soar.repeated(ids)
        hits_leaf += soar.recall(ids, leaf_truth[qi]) * int(
            (leaf_truth[qi] >= 0).sum())
        hits_all += soar.recall(ids, truth[qi]) * truth[qi].numel()
        safe = torch.clamp_min(ids, 0)
        d = torch.as_tensor(dist_all[i:i + BLOCK], device=dev).double()
        ref = exact_knn.distances64(rows_t, q, safe, measure)
        scale = exact_knn.scale64(rows_t, q, safe, measure)
        gap = max(gap, float(((d - ref).abs()
                              / torch.clamp_min(scale, 1e-30)).max()))
    a = report["assignment"]
    bars = {
        "primary_not_tied": (a["primary_not_tied"], 0),
        "secondary_not_near_tie": (a["secondary_not_near_tie"], 0),
        "secondary_is_primary": (a["secondary_is_primary"], 0),
        "secondary_differ_share": (
            a["secondary_differ"] / max(a["secondary_compared"], 1), 0.001),
        "secondary_slots_off": (abs(secondary_slots - len(rows)), 0),
        "pool_unanswered": (pool_n - pool_answered, 0),
        "outside_searched": (outside, 0),
        "repeated": (repeated, 0),
        "dist_gap": (gap, limits["dist_gap"]),
        "recall_short_leaf": (1.0 - hits_leaf / max(n * k, 1),
                              1.0 - RECALL_LEAF_BAR),
        "recall_short": (1.0 - hits_all / max(n * k, 1),
                         limits["recall_short"]),
    }
    report.update({
        "answered": n, "answered_in_window": len(window.ids),
        "pool_queries": pool_n, "secondary_slots": secondary_slots,
        "leaves": leaves,
        "outside_by_layout": outside_layout,
        "recall_leaf_restricted": hits_leaf / max(n * k, 1),
        "recall_global": hits_all / max(n * k, 1),
        "build_s": build_s, "check_s": time.perf_counter() - t,
        "bars": {name: {"value": v, "at_most": b, "ok": v <= b}
                 for name, (v, b) in bars.items()},
    })
    report["ok"] = all(x["ok"] for x in report["bars"].values())
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from portbench.harness import core, spec
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    seconds = args.seconds or bench["run_seconds"]
    r = run_check(spec.load_config(bench, cell["config"]),
                  spec.load_traffic(cell["traffic"]),
                  spec.load_limits(args.workload), args.seed, seconds,
                  args.device, log=lambda m: print(m, file=sys.stderr))
    dev = torch.device(args.device)
    r.update(workload=args.workload, seed=args.seed, seconds=seconds,
             device=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
             power_limit=core.power_limit() if dev.type == "cuda" else None)
    print(json.dumps(r), flush=True)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
