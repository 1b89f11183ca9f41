#!/usr/bin/env python3
"""Which Monte Carlo runs fail, and why: a scan of a cell's studies that
lists every QP the float32 solver left unconverged.

    python3 experiments/mc_failures.py [--cell head_on_n20.mc300]
        [--seed 3913000401] [--studies 1000] [--first 0] [--only I,J]
        [--runs N]
        [--qp_iters N] [--device cuda] [--out FILE]

Study i runs `run_monte_carlo_simulation` as the benchmark's Monte Carlo
driver calls it (`benchmark/drivers/mc_study.py`): the cell's
configuration, its traffic's runs (or `--runs`), qp_iters and qp_tol,
seed `derive_seed(seed, "study", i)`.  Every QP of a study is one lane of
one `solve_mpc_qp` call (run r, metric m is lane 3 r + m).  For each lane
the float32 loop left unconverged it prints one JSON line: study, its
seed, run, metric, float32 iterations and best merit, the stop reason
(`cap`: the iteration cap; `stall`: ten passes without a 0.5% gain;
`breakdown`: a non-finite merit), whether the program's answer converged
in the end (where the solver re-solves such lanes, its rescue; else the
float32 answer), and the lane solved again in float64 from a cold start
and warm from the float32 iterate, with the same cap and tolerance.  The
last line sums up: studies, runs, QPs, failing runs before and after the
program's own answer, lanes by stop reason, and the card.

The float32 answer before any rescue is read where the solver has a
`_rescue` step, by wrapping it; the stop reason from the loop's last
state, seen by wrapping `_still_active` (the solver's readback a pass)
and reading the stall counter of its caller's state.  A solver without
the rescue or the CUDA graphs (its loop state a local `state` tuple) is
scanned too, its float32 answer then being its final one, so one copy of
the script compares two versions of the port.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402
import roofline  # noqa: E402

METRICS = ("mean", "cvar", "dr_cvar")


def _stall_of(frame_locals):
    """The stall counter of the loop state held by the caller of
    `_still_active`: the op-by-op loop's `st` or `state`, or the graphs'
    buffers."""
    if "graphs" in frame_locals:
        return frame_locals["graphs"].state.stall
    if "st" in frame_locals:
        return frame_locals["st"].stall
    return frame_locals["state"][4]


class Spy:
    """Wraps the solver's functions for one scan; `restore` undoes it."""

    def __init__(self, pt):
        self.qps = pt.ops.qp_ipm_structured
        self.filt = pt.models.mpc_filter
        self.saved = [(self.filt, "solve_mpc_qp", self.filt.solve_mpc_qp),
                      (self.qps, "_still_active", self.qps._still_active)]
        if hasattr(self.qps, "_rescue"):
            self.saved.append((self.qps, "_rescue", self.qps._rescue))
        self.calls = []
        real_solve, real_active = self.saved[0][2], self.saved[1][2]

        def solve(*args, **kwargs):
            rec = {"args": args, "kwargs": kwargs, "pre": None, "stall": None}
            self.calls.append(rec)
            rec["final"] = real_solve(*args, **kwargs)
            if rec["pre"] is None:
                rec["pre"] = rec["final"]
            return rec["final"]

        def still_active(active):
            rec = self.calls[-1] if self.calls else None
            if rec is not None and rec["pre"] is None:
                stall = _stall_of(sys._getframe(1).f_locals)
                if stall.dtype == torch.int32 and rec["args"][1].dtype == \
                        torch.float32:
                    rec["stall"] = stall.clone()
            return real_active(active)

        self.filt.solve_mpc_qp = solve
        self.qps._still_active = still_active
        if len(self.saved) == 3:
            real_rescue = self.saved[2][2]

            def rescue(d, spec, sol, *rest):
                rec = self.calls[-1]
                if rec["pre"] is None:
                    rec["pre"] = sol
                return real_rescue(d, spec, sol, *rest)

            self.qps._rescue = rescue

    def restore(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _resolve(qps, args, kwargs, j, warm):
    """Lane j of a solve's QPs solved again in float64, cold or warm from
    `warm` (u, s, l1, l2, l3 of the batch): (converged, iterations,
    merit)."""
    f64 = torch.float64

    def lane(t, per_lane_dims):
        if not torch.is_tensor(t):
            return t
        t = t.to(f64)
        return t[j:j + 1] if t.dim() == per_lane_dims else t

    P_uu, q_u, G_u, h1, A, b, p_ss, q_s = args
    picked = (lane(P_uu, 3), lane(q_u, 2), lane(G_u, 3), lane(h1, 2),
              lane(A, 3), lane(b, 2), lane(p_ss, 2), lane(q_s, 2))
    kw = dict(kwargs)
    if kw.get("box_theta") is not None:
        kw["box_theta"] = kw["box_theta"].to(f64)
    kw["tol"] = kw.get("tol") if kw.get("tol") is not None else 3e-5
    if warm is not None:
        kw["warm"] = tuple(t[j:j + 1].to(f64) for t in warm)
    sol = qps.solve_mpc_qp(*picked, **kw)
    return (bool(sol.converged[0]), int(sol.iterations[0]),
            float(sol.merit[0]))


def scan_study(pt, spy, mc, ctx, statics, runs, study, seed, emit):
    """One study; emits a line per float32-unconverged lane.  Returns
    (failing runs before, failing runs after, reasons)."""
    torch_ = ctx.torch
    spy.calls.clear()
    res = mc.run_monte_carlo_simulation(
        ctx.scenario, ctx.params, n_runs=runs, seed=seed,
        dtype=getattr(torch_, ctx.config["dtype"]), device=ctx.device,
        statics=statics, chunk_size=ctx.traffic["chunk_size"],
        qp_iters=ctx.config["qp_iters"])
    final_bad = int((~res.qp_converged.all(1)).sum())
    before, reasons, offset = set(), [], 0
    for rec in spy.calls:
        pre, final = rec["pre"], rec["final"]
        max_iters = rec["kwargs"].get("max_iters", 60)
        bad = (~pre.converged).nonzero()[:, 0].tolist()
        stall = rec["stall"]
        for j in bad:
            it = int(pre.iterations[j])
            merit = float(pre.merit[j])
            if it >= max_iters:
                reason = "cap"
            elif stall is not None and int(stall[j]) >= 10:
                reason = "stall"
            else:
                reason = "breakdown"
            warm = (pre.u, pre.s, *pre.mults)
            cold64 = _resolve(spy.qps, rec["args"], rec["kwargs"], j, None)
            warm64 = _resolve(spy.qps, rec["args"], rec["kwargs"], j, warm)
            lane = offset + j
            before.add(lane // 3)
            reasons.append(reason)
            emit({"study": study, "seed": seed, "run": lane // 3,
                  "metric": METRICS[lane % 3], "iterations_f32": it,
                  "best_merit_f32": merit, "stop": reason,
                  "converged_in_the_end": bool(final.converged[j]),
                  "iterations_in_the_end": int(final.iterations[j]),
                  "f64_cold": dict(zip(("converged", "iterations", "merit"),
                                       cold64)),
                  "f64_warm": dict(zip(("converged", "iterations", "merit"),
                                       warm64))})
        offset += pre.u.shape[0]
    return len(before), final_bad, reasons


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="head_on_n20.mc300")
    ap.add_argument("--seed", type=int, default=3913000401)
    ap.add_argument("--studies", type=int, default=1000)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma-separated study indices, in place of "
                         "--first / --studies")
    ap.add_argument("--runs", type=int, default=None,
                    help="runs a study (default: the traffic's)")
    ap.add_argument("--qp_iters", type=int, default=None,
                    help="the IPM's iteration cap (default: the cell's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    cell = harness.find_cell(ROOT, args.cell, {"config": {
        "qp_iters": args.qp_iters}} if args.qp_iters else None)
    ctx = harness.make_ctx(cell, args.seed, args.device, torch)
    pt = ctx.pt
    runs = args.runs or ctx.traffic["runs"]
    statics = pt.models.make_statics(ctx.scenario, ctx.params,
                                     getattr(torch, ctx.config["dtype"]),
                                     ctx.device)
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()

    card = (roofline.card_line() if torch.device(args.device).type == "cuda"
            else "cpu")
    spy = Spy(pt)
    t0 = time.perf_counter()
    before = after = 0
    reasons = []
    try:
        studies = ([int(i) for i in args.only.split(",")] if args.only
                   else range(args.first, args.first + args.studies))
        for i in studies:
            seed = harness.derive_seed(args.seed, "study", i)
            b, a, r = scan_study(pt, spy, pt.evaluation.monte_carlo, ctx,
                                 statics, runs, i, seed, emit)
            before, after = before + b, after + a
            reasons += r
    finally:
        spy.restore()
    summary = {"cell": args.cell, "seed": args.seed,
               "studies": f"{studies[0]}-{studies[-1]}" if not args.only
               else args.only, "runs": len(studies) * runs,
               "qps": 3 * len(studies) * runs,
               "failing_runs_f32": before, "failing_runs_in_the_end": after,
               "lanes_by_stop": {k: reasons.count(k)
                                 for k in ("cap", "stall", "breakdown")},
               "rescue": hasattr(pt.ops.qp_ipm_structured, "_rescue"),
               "seconds": time.perf_counter() - t0, "device": card}
    emit(summary)
    if out is not None:
        out.close()
    return summary


if __name__ == "__main__":
    main()
