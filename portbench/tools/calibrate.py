"""Readings for the limits of `correct`: one cell run in one process over
several seeds, as the program (``sound``), as the control (the
reference in the program's place, one precision down) and with each
fault of harness/faults.py planted.  One JSON line a run: the seed, the
variant, `correct` and the numbers compared.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --variants control,half_batch,answer_altered --seconds 10
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    from portbench.harness import core
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="control,half_batch,"
                                          "answer_altered")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for seed in (int(x) for x in args.seeds.split(",")):
        for variant in args.variants.split(","):
            r = core.run_cell(args.workload, seed, args.seconds, False,
                              device=args.device,
                              variant=None if variant == "sound"
                              else variant)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"],
                              "metrics": r["metrics"]}), flush=True)


if __name__ == "__main__":
    main()
