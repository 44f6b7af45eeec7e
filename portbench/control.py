"""The comparison's control, at a cell's own size: the plain reference
with its float stages rounded to bfloat16 (the precision below the
configuration's float32) put in the program's place, judged as a run
judges the program.  Prints one JSON line per seed with the compared
numbers; every seed has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    import argparse

    sys.path[0] = ROOT
    from portbench import harness

    p = argparse.ArgumentParser(prog="python3 portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(a.workload, seed, 0.0, False, a.device, t0,
                             control=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
