#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <a,b,...> --control-seeds <c,d,e> [--out FILE]

Runs the cell (harness.run, untraced) once a seed in one process, with a
short window at the cell's own load, and prints one JSON line a run:
the program's numbers (`check`) and, on the control seeds, the control's
numbers on the same inputs (the reference computed in TF32 in the
program's place, which has to come out as not correct). The last line is
a summary: per number the largest program reading (the lower reading)
and the smallest control reading (the upper). Each line also gives the
worst scaled residual the float64 reference's QP solves reached. `--out` also writes the
lines to FILE. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import harness
    import roofline
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(roofline.card_line(), flush=True)
    import reference
    solve, residuals = reference.solve_qp, []

    def spy(qp, ar, **kw):
        z, f, res = solve(qp, ar, **{**kw, "return_residual": True})
        if ar is reference.FLOAT64:
            residuals.append(float(res.max()))
        return z, f
    reference.solve_qp = spy
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lines, lower, upper = [], {}, {}
    for seed in seeds + [s for s in controls if s not in seeds]:
        t0 = time.perf_counter()
        residuals.clear()
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          device="cuda", control=seed in controls,
                          log=lambda s: None)
        line = {"seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "program": {k: c["value"] for k, c in res["check"].items()},
                "control": res.get("control"),
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "wall_s": time.perf_counter() - t0,
                "reference_qp_residual": max(residuals, default=None)}
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (line["control"] or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "lower": lower, "upper": upper}
    print(json.dumps(summary), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(json.dumps(x) for x in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
