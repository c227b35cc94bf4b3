"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device; with --trace 1
also breakdown; then the numbers compared, each beside its limit); the
lines before it say more about the run, and the last lines of standard
error repeat the numbers compared.  Without a CUDA card, with fewer cards
than the cell asks for, or without the program beside BENCHMARK.json, it
prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache inside the checkout, at fixed paths.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "scann_torch")):
        print("no program to measure: scann_torch/ is not beside "
              "BENCHMARK.json", file=sys.stderr)
        return 3
    import torch
    from portbench.harness import check, core, spec

    cell = spec.find(spec.load_benchmark()["workloads"], args.workload,
                     "workload")
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    info = result.pop("_info")
    print(json.dumps({"info": info}), flush=True)
    for line in check.check_lines(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
