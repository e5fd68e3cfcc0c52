"""The control's readings: each seed's cell run once, and the sampled
requests answered a second time by the reference in the precision below
the configuration's (``reference/lowp.py``), put in the program's place.
Both sets of numbers are printed, one JSON line a seed, so that a limit
can be set between the program's readings and the control's.

    python -m freddy_bench.control --workload <cell> --seeds 1,2,3 \
        --seconds 5

The benchmark's own runs never run it.
"""

import json
import sys

if __name__ == "__main__":
    import argparse

    from freddy_bench import harness

    ap = argparse.ArgumentParser(prog="python -m freddy_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run(args.workload, seed, args.seconds, False,
                        control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "program": r["numbers"],
                          "control": r["control"],
                          "metrics": r["metrics"]}), flush=True)
    sys.exit(0)
