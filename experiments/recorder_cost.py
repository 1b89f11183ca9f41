#!/usr/bin/env python3
"""What the port's recorder costs when on: benchmark cells driven in one
process on the card, the recorder off and on in turns, call by call.

    python3 experiments/recorder_cost.py [--calls 400] [--seed 1] [CELL ...]

First one untraced run of the first cell through the benchmark's harness
(`benchmark/harness.py`, 5 s), which must leave the recorder's totals
empty. Then, for each cell, its driver's set-up and three warm-up calls,
and `--calls` calls in pairs on the same inputs (the driver's same call
index: the same pool draw, the same study), one with the recorder off and
one on, in turns off-on and on-off (so neither the inputs nor a drift of
the host falls on one side); each call's latency is the driver's own
(for the loop cell a plan, until its controls are on the host). Prints
the card's line, then one JSON line a cell: the median and mean ms a
call with the recorder off and on, the median over pairs of on / off
minus one, the ratio of the means minus one, and the recorder's totals
over the calls with it on (where their host time goes).
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402
import roofline  # noqa: E402
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.utils import (  # noqa: E402
    timing)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*",
                    default=["multi_obstacle_n1000.loop",
                             "multi_obstacle_n1000.batch256"])
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    print(roofline.card_line(), flush=True)

    res = harness.run(ROOT, args.cells[0], args.seed, 5.0, False,
                      log=lambda s: None)
    print(json.dumps({"untraced_run_correct": res["correct"],
                      "recorder_on": timing.RECORDING,
                      "totals": timing.totals()}), flush=True)

    for cell_name in args.cells:
        cell = harness.find_cell(ROOT, cell_name)
        ctx = harness.make_ctx(cell, args.seed, "cuda", torch)
        drv = cell.driver
        state = drv.setup(ctx)
        for i in range(3):
            drv.call(state, i)
        ms = {False: [], True: []}
        for j in range(args.calls // 2):
            for on in ((False, True) if j % 2 else (True, False)):
                timing.record(on)
                ms[on].append(drv.call(state, 3 + j).latency_s * 1e3)
        timing.record(False)
        line = {"cell": cell_name, "calls": args.calls}
        for on, name in ((False, "off"), (True, "on")):
            line[f"median_ms_{name}"] = statistics.median(ms[on])
            line[f"mean_ms_{name}"] = statistics.fmean(ms[on])
        line["median_pair_on_over_off_minus_1"] = statistics.median(
            a / b - 1 for a, b in zip(ms[True], ms[False]))
        line["mean_on_over_off_minus_1"] = (line["mean_ms_on"]
                                            / line["mean_ms_off"] - 1)
        line["totals_on"] = timing.totals()
        print(json.dumps(line), flush=True)
        del state
        timing.reset()


if __name__ == "__main__":
    main()
