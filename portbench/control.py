"""The readings a cell's correctness limit is set from: for each seed, one
run of the cell (set-up, a short window at the cell's own load, the check)
with the served-token gap of the program and, on the same sample, the gap
of the control -- the reference with every decoder matrix in symmetric
per-row int8, the precision below the bf16 the configuration serves.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 --seconds 12

On the card; one JSON line per seed, then one with the largest program
gap and the smallest control gap.  The benchmark's own runs do not run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run as run_mod  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", type=int, default=1)
    a = p.parse_args()
    prog, ctrl = [], []
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
        out = run_mod.run_cell(args, t_start=time.perf_counter(),
                               control="int8" if a.control else None)
        gap = out["compared"]["served_gap"]["value"]
        prog.append(gap)
        if "control_gap" in out["check"]:
            ctrl.append(out["check"]["control_gap"])
        print(json.dumps({"seed": seed, "served_gap": gap, **out["check"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
              flush=True)
    print(json.dumps({"workload": a.workload, "lower": max(prog),
                      "upper": min(ctrl) if ctrl else None, "program": prog, "control": ctrl}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
