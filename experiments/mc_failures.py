#!/usr/bin/env python3
"""Which Monte Carlo runs fail, and why: a scan of a cell's studies that
lists every QP the float32 solver left unconverged.

    python3 experiments/mc_failures.py [--cell head_on_n20.mc300]
        [--seed 3913000401] [--studies 1000] [--first 0] [--only I,J]
        [--runs N] [--qp_iters N] [--device cuda] [--out FILE]
        [--draws program|loop|compare] [--save_dir DIR]

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
and warm from the float32 iterate, with the same cap and tolerance, and
from the cold start with one step length for primal and dual variables
(the rescue's second start; null for a solver without it).  A
run whose minimum distances are not all finite gets a line too.  The
last line sums up: studies, runs, QPs, failing runs before and after the
program's own answer (a run fails, as the benchmark counts it,
when one of its QPs did not converge or a minimum distance is not
finite), lanes by stop reason, the solver's rescue counters (`ipm.*`
counters of the port's recorder, switched on for the scan), and the card.

`--draws` says where a study's obstacles come from: `program` (default)
as `run_obstacles` draws them (on a CUDA float32 chunk the draw kernel);
`loop` one generator a run in a Python loop, whatever the device (the
path before the draw kernel); `compare` the program's draws, each chunk
drawn again by the loop and compared bit for bit (the summary counts the
chunks and studies that differ, and each differing chunk gets a line).
`--save_dir` writes each failing run's obstacle draw (nominal, samples,
realization of that run alone) to `DIR/study<i>_run<r>.npz`, and each
float32-unconverged lane's QP (the solve's arguments for that lane, and
its float32 answer) to `DIR/study<i>_run<r>_<metric>_qp.npz`.

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

import numpy as np

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

    def __init__(self, pt, draws="program"):
        self.qps = pt.ops.qp_ipm_structured
        self.filt = pt.models.mpc_filter
        self.mc = pt.evaluation.monte_carlo
        self.saved = [(self.filt, "solve_mpc_qp", self.filt.solve_mpc_qp),
                      (self.qps, "_still_active", self.qps._still_active)]
        real_rescue = getattr(self.qps, "_rescue", None)
        if real_rescue is not None:
            self.saved.append((self.qps, "_rescue", real_rescue))
        self.calls, self.chunks = [], []
        real_solve, real_active = self.saved[0][2], self.saved[1][2]
        self._wrap_draws(draws)

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
                q_u = rec["args"][1]
                if stall.dtype == torch.int32 and q_u.dtype == \
                        torch.float32 and stall.shape[0] == q_u.shape[0]:
                    rec["stall"] = stall.clone()
            return real_active(active)

        self.filt.solve_mpc_qp = solve
        self.qps._still_active = still_active
        if real_rescue is not None:

            def rescue(d, spec, sol, *rest):
                rec = self.calls[-1]
                if rec["pre"] is None:
                    rec["pre"] = sol
                return real_rescue(d, spec, sol, *rest)

            self.qps._rescue = rescue

    def _wrap_draws(self, draws):
        """Keep each chunk's draw (`chunks`: [ObstacleData, bits that
        differ from the loop's or None]); `loop` draws by the loop,
        `compare` also by the loop, and counts the differing bits."""
        mc = self.mc
        real_draw = mc.run_obstacles
        real_use = getattr(mc, "use_draw_kernel", None)
        self.saved.append((mc, "run_obstacles", real_draw))
        if real_use is not None:
            self.saved.append((mc, "use_draw_kernel", real_use))

        def by_loop(*args):
            if real_use is None:        # a port without the draw kernel
                return real_draw(*args)
            mc.use_draw_kernel = lambda *a: False
            try:
                return real_draw(*args)
            finally:
                mc.use_draw_kernel = real_use

        def draw(*args):
            got = by_loop(*args) if draws == "loop" else real_draw(*args)
            diff = None
            if draws == "compare":
                want = by_loop(*args)
                diff = sum(int((a.view(torch.int32) != b.view(torch.int32))
                               .sum()) for a, b in zip(got, want))
            self.chunks.append([got, diff])
            return got

        mc.run_obstacles = draw

    def restore(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def _resolve(qps, args, kwargs, j, warm, one_step=False):
    """Lane j of a solve's QPs solved again in float64, cold or warm from
    `warm` (u, s, l1, l2, l3 of the batch), with one step length for
    primal and dual variables where `one_step` (the rescue's cold start;
    None where the solver has no such start): (converged, iterations,
    merit)."""
    f64 = torch.float64
    if one_step and "one_step" not in getattr(qps, "_Spec")._fields:
        return None

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
    if one_step:
        d, spec = qps._prepare(*picked, kw.get("max_iters", 60), kw["tol"],
                               kw.get("box_theta"))
        sol = qps._ipm_eager(d, spec._replace(one_step=True), None)
    else:
        sol = qps.solve_mpc_qp(*picked, **kw)
    return (bool(sol.converged[0]), int(sol.iterations[0]),
            float(sol.merit[0]))


def _save_run(save_dir, chunks, study, run):
    """Run `run`'s obstacle draw of the study's chunks to an .npz."""
    start = 0
    for obs in chunks:
        S = obs.nominal.shape[0]
        if run < start + S:
            k = run - start
            np.savez(Path(save_dir) / f"study{study}_run{run}.npz",
                     **{f: getattr(obs, f)[k:k + 1].cpu().numpy()
                        for f in obs._fields})
            return
        start += S


def _save_qp(save_dir, rec, pre, j, study, lane):
    """Lane j's QP of a solve (its arguments, lane j of each per-lane
    one) and its float32 answer before any rescue, to an .npz."""
    names = ("P_uu", "q_u", "G_u", "h1", "A", "b", "p_ss", "q_s")
    per_lane = dict(zip(names, (3, 2, 3, 2, 3, 2, 2, 2)))
    out = {}
    for name, t in zip(names, rec["args"]):
        if torch.is_tensor(t):
            out[name] = (t[j:j + 1] if t.dim() == per_lane[name] else t
                         ).cpu().numpy()
        else:
            out[name] = np.asarray(t)
    theta = rec["kwargs"].get("box_theta")
    if theta is not None:
        out["box_theta"] = theta.cpu().numpy()
    out["max_iters"] = np.asarray(rec["kwargs"].get("max_iters", 60))
    for f in ("u", "s", "converged", "iterations", "merit"):
        out["f32_" + f] = getattr(pre, f)[j:j + 1].cpu().numpy()
    for k, m in enumerate(pre.mults):
        out[f"f32_l{k + 1}"] = m[j:j + 1].cpu().numpy()
    np.savez(Path(save_dir) / f"study{study}_run{lane // 3}_"
             f"{METRICS[lane % 3]}_qp.npz", **out)


def scan_study(pt, spy, mc, ctx, statics, runs, study, seed, emit,
               save_dir=None):
    """One study; emits a line per float32-unconverged lane, per run with
    a minimum distance that is not finite, and per chunk whose draws
    differ from the loop's.  Returns (failing runs before, failing runs
    after, reasons, chunks compared, chunks that differ)."""
    torch_ = ctx.torch
    spy.calls.clear()
    spy.chunks.clear()
    res = mc.run_monte_carlo_simulation(
        ctx.scenario, ctx.params, n_runs=runs, seed=seed,
        dtype=getattr(torch_, ctx.config["dtype"]), device=ctx.device,
        statics=statics, chunk_size=ctx.traffic["chunk_size"],
        qp_iters=ctx.config["qp_iters"])
    finite = torch_.isfinite(res.min_distances).all(1)
    final_bad = int((~res.qp_converged.all(1) | ~finite).sum())
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
            if save_dir is not None:
                _save_qp(save_dir, rec, pre, j, study, offset + j)
            cold64 = _resolve(spy.qps, rec["args"], rec["kwargs"], j, None)
            warm64 = _resolve(spy.qps, rec["args"], rec["kwargs"], j, warm)
            one64 = _resolve(spy.qps, rec["args"], rec["kwargs"], j, None,
                             one_step=True)
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
                                       warm64)),
                  "f64_cold_one_step": one64 and dict(zip(
                      ("converged", "iterations", "merit"), one64))})
        offset += pre.u.shape[0]
    for run in (~finite).nonzero()[:, 0].tolist():
        before.add(run)
        emit({"study": study, "seed": seed, "run": run,
              "min_distances": res.min_distances[run].tolist(),
              "qp_converged": res.qp_converged[run].tolist()})
    if save_dir is not None:
        for run in sorted(before):
            _save_run(save_dir, [c[0] for c in spy.chunks], study, run)
    compared = [c[1] for c in spy.chunks if c[1] is not None]
    for k, diff in enumerate(compared):
        if diff:
            emit({"study": study, "seed": seed, "chunk": k,
                  "draw_bits_differing": diff})
    return (len(before), final_bad, reasons, len(compared),
            sum(1 for d in compared if d))


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
    ap.add_argument("--draws", default="program",
                    choices=("program", "loop", "compare"))
    ap.add_argument("--save_dir", default=None,
                    help="write each failing run's obstacle draw here")
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
    if args.save_dir:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    spy = Spy(pt, args.draws)
    timing = pt.utils.timing
    was, counts0 = timing.record(True), timing.totals()
    t0 = time.perf_counter()
    before = after = compared = differing = 0
    reasons, studies_differing = [], []
    try:
        studies = ([int(i) for i in args.only.split(",")] if args.only
                   else range(args.first, args.first + args.studies))
        for i in studies:
            seed = harness.derive_seed(args.seed, "study", i)
            b, a, r, c, d = scan_study(pt, spy, pt.evaluation.monte_carlo,
                                       ctx, statics, runs, i, seed, emit,
                                       args.save_dir)
            before, after = before + b, after + a
            compared, differing = compared + c, differing + d
            if d:
                studies_differing.append(i)
            reasons += r
    finally:
        spy.restore()
        counts = timing.since(counts0)["counts"]
        timing.record(was)
    summary = {"cell": args.cell, "seed": args.seed,
               "studies": f"{studies[0]}-{studies[-1]}" if not args.only
               else args.only, "runs": len(studies) * runs,
               "qps": 3 * len(studies) * runs,
               "failing_runs_f32": before, "failing_runs_in_the_end": after,
               "lanes_by_stop": {k: reasons.count(k)
                                 for k in ("cap", "stall", "breakdown")},
               "rescue": hasattr(pt.ops.qp_ipm_structured, "_rescue"),
               "rescue_counts": {k: v for k, v in sorted(counts.items())
                                 if k.startswith("ipm.rescue")},
               "draws": args.draws,
               "draw_kernel_runs": counts.get("obstacles.kernel_runs", 0),
               "draw_loop_runs": counts.get("obstacles.loop_runs", 0),
               "chunks_compared": compared, "chunks_differing": differing,
               "studies_differing": studies_differing,
               "seconds": time.perf_counter() - t0, "device": card}
    emit(summary)
    if out is not None:
        out.close()
    return summary


if __name__ == "__main__":
    main()
