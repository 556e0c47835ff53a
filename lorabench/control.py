"""Readings for the check's limits: the program's numbers and the
control's, for one cell over many seeds, in one process.

    python3 -m lorabench.control --workload fsm64.collide \\
        --seeds 11,12,13 --seconds 3

Each seed is a short run of the cell at its own size (the harness's set-up
and window, then its check), and the control is the reference put in the
program's place one precision below the configuration's
(``control_precision`` in the configuration's file): the FSM's detection
spectra at bfloat16 where cuFFT runs in float32.
Prints one JSON line a seed, ``{"seed", "program", "control"}``, then one
with the largest program reading and the smallest control reading of each
number.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from lorabench import harness

    lower, upper = {}, {}
    for seed in map(int, args.seeds.split(",")):
        res = harness.run(args.workload, seed, args.seconds, False,
                          control=True)
        prog = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"seed": seed, "program": prog,
                          "control": res["control"]}), flush=True)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in res["control"].items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"program_max": lower, "control_min": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
