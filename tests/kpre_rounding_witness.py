"""chip_smoke.py's per-query pre_reorder_num_neighbors check on several
builds of phase 12's config-4 SOAR index (the bench corpus, 250,000
training samples, 40 leaves): for each build the check's counts (rows
whose 20th candidate ties the 21st, rows with k_pre 20 that differ from
the scalar search, and those that differ only by the rescore's rounding)
or its failure, and for every id where such a row differs, its float64
dot product with the query.  The builds differ from run to run (k-means on
the card).  Not a test; needs one CUDA card; run from the repository root:

    python tests/kpre_rounding_witness.py [builds] [seconds]

Stops starting builds after ``seconds``.  Prints one JSON object a build
and a closing one.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import scann_torch  # noqa: E402


def differing_dots(searcher, db, queries):
    """{row: {id: float64 dot}} over the ids where a k_pre-20 row of the
    per-query search and the scalar search differ."""
    nq = queries.shape[0]
    kw = dict(leaves_to_search=chip_smoke.SOAR_LEAVES)
    pres = np.where(np.arange(nq) % 2 == 0, 20,
                    chip_smoke.SOAR_REORDER).astype(np.int32)
    idx, _ = searcher.search_batched(queries, pre_reorder_num_neighbors=pres,
                                     **kw)
    small, _ = searcher.search_batched(queries, pre_reorder_num_neighbors=20,
                                       **kw)
    out = {}
    for r in np.nonzero((idx[::2] != small[::2]).any(1))[0] * 2:
        moved = set(idx[r][idx[r] != small[r]]) | set(
            small[r][idx[r] != small[r]])
        q = queries[r].astype(np.float64)
        out[int(r)] = {int(i): float(db[i].astype(np.float64) @ q)
                       for i in sorted(moved)}
    return out


def main():
    builds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    budget = float(sys.argv[2]) if len(sys.argv) > 2 else 300.0
    torch.backends.cuda.matmul.allow_tf32 = False
    db, queries = chip_smoke.make_glove_like(chip_smoke.N_DB,
                                             chip_smoke.N_QUERY,
                                             chip_smoke.DIM)
    q_dev = torch.as_tensor(queries, device="cuda")
    results = []
    t0 = time.perf_counter()
    for b in range(builds):
        if time.perf_counter() - t0 > budget:
            break
        s = scann_torch.create_searcher(db, chip_smoke.soar_config(
            scann_torch, db, "int8", True, chip_smoke.SOAR_TRAIN), "cuda")
        base_i, _ = s.search_batched(queries,
                                     leaves_to_search=chip_smoke.SOAR_LEAVES)
        rec = {"build": b}
        try:
            rec["ties"], rec["differ"], rec["rounding"] = (
                int(x) for x in chip_smoke.check_k_pre_rows(
                    torch, s, queries, q_dev, base_i, 20,
                    chip_smoke.SOAR_REORDER, chip_smoke.SOAR_LEAVES))
            rec["ok"] = True
        except AssertionError as e:
            rec["ok"], rec["error"] = False, str(e)
        rec["float64_dots"] = differing_dots(s, db, queries)
        results.append(rec)
        print(json.dumps(rec), flush=True)
        s = None
        torch.cuda.empty_cache()
    print(json.dumps({
        "card": chip_smoke.nvidia_smi_line(), "builds": len(results),
        "passed": sum(r["ok"] for r in results),
        "with_rounding_rows": sum(r.get("rounding", 0) > 0
                                  for r in results)}))


if __name__ == "__main__":
    main()
