"""The IPM loop's matmul precision against its throughput and answers.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.precbench \
        [--batch 2048] [--device cuda|cpu] [--repeats 5] [--k 8]

Port of the JAX package's experiments/precbench.py.  `solve_mpc_qp`
runs its iteration loop at `ipm_precision` ("highest", "high" or
"default"; on the card the last two allow TF32 in the loop's matmuls)
while the polish and the reported residuals stay at full float32.  At
the bench shape (qpbench's data: batch 2048, H = 30, 3 obstacles, 35
iterations) each setting prints its time a solve (the median of the
repeats of K chained solves, with the spread), QP/s, the converged share
and max |u - u_highest| against the "highest" run on the same QPs.  On
the CPU the three settings compute the same thing (nothing global is
touched there), so the distances read 0.
"""

from __future__ import annotations

import argparse

import torch

from ..config import DEFAULT_DEVICE
from ..ops.qp_ipm_structured import IPM_PRECISIONS, solve_mpc_qp
from .qpbench import assemble, make_data, time_chain

MAX_ITERS = 35


def run(batch: int = 2048, device=DEFAULT_DEVICE, repeats: int = 5,
        k: int = 8, seed: int = 0) -> dict:
    """Time and solve at each setting; returns {setting: result}."""
    prob, data = make_data(batch, seed, device)
    P_uu, q_u, G_u, h1, HS_u, hs_rhs, p_ss, q_s = assemble(prob, *data)
    out, u_highest = {}, None
    for prec in IPM_PRECISIONS:
        def solve(q, prec=prec):
            return solve_mpc_qp(P_uu, q, G_u, h1, HS_u, hs_rhs, p_ss, q_s,
                                max_iters=MAX_ITERS, tol=3e-5,
                                ipm_precision=prec)

        sol = solve(q_u)                    # warm-up and the answer
        r = time_chain(solve, q_u, k, repeats)
        if u_highest is None:
            u_highest = sol.u
        r.update(converged=float(sol.converged.float().mean()),
                 u_dist=float((sol.u - u_highest).abs().max()),
                 qp_per_s=batch / (r["ms"] * 1e-3),
                 iters_mean=float(sol.iterations.float().mean()),
                 iters_max=int(sol.iterations.max()))
        out[prec] = r
    return out


def format_line(prec: str, r: dict) -> str:
    return (f"{prec:8s}: {r['ms']:8.3f} ms a solve (median of "
            f"{r['repeats']} x {r['k']} chained, spread {r['ms_min']:.3f}-"
            f"{r['ms_max']:.3f}) {r['qp_per_s']:9.0f} QP/s  "
            f"conv={r['converged']:.3f} iterations mean "
            f"{r['iters_mean']:.4f} max {r['iters_max']} "
            f"max|u-u_highest|={r['u_dist']:.2e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--device", default=DEFAULT_DEVICE)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--k", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    out = run(args.batch, args.device, args.repeats, args.k, args.seed)
    for prec, r in out.items():
        print(format_line(prec, r), flush=True)
    return out


if __name__ == "__main__":
    main()
