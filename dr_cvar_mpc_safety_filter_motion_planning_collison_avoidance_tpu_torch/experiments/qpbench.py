"""Throughput of the structured MPC IPM's variants at the bench shape.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.qpbench \
        [SPEC ...] [--device cuda|cpu] [--repeats 5] [--k K]

Port of the JAX package's experiments/qpbench.py.  A SPEC is
`NAME:BATCH[:ITERS][:nopol]` (default `chol:2048`; ITERS is the IPM's
max_iters, 35 by default; `nopol` leaves the polish out):

  * chol: `solve_mpc_qp` with a dense G_u;
  * bt: chol with the structured `box_theta` operators;
  * diag: `_factor` / `_solve` replaced by a diagonal solve and no
    polish (wrong maths: it times everything in the IPM but the
    factorisations and solves);
  * pnone: the polish replaced by the identity (as `nopol`);
  * pref0, pref1: 0 or 1 KKT refinement rounds in the polish instead
    of 2 (`POLISH_REFINEMENTS`);
  * pnotopk: the polish's row selection (`_select_rows`, a topk) replaced
    by the first k rows.

Each variant rebinds names of the port's `ops/qp_ipm_structured` and
restores them on the way out, and drops the solver's cached CUDA graphs
on the way in and out, so that the graphs it replays run its own
functions.  The data are the JAX script's: batch
QPs of the custom preset (H = 30, 3 obstacles), x0, x_ref, the normals
and the offsets drawn from the same laws with a seeded torch.Generator,
and the QP matrices assembled before any timing.  A timed repeat runs K
chained solves (each solve's q_u moved by 1e-6 of the previous answer)
between two `torch.cuda.synchronize()`; the line gives the median time
a solve over the repeats with its spread (min-max), QP/s at the median,
and the IPM iterations (mean, max) and converged share of one solve, so
that a wall moved through iterations shows.  The JAX script's chained
`fori_loop` on the device has no counterpart: the port's loop is driven
from the host.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import torch

from ..config import DEFAULT_DEVICE, get_parameters
from ..core.dynamics import create_double_integrator_matrices
from ..models.mpc_filter import SLACK_LIN, SLACK_QUAD, build_mpc_problem
from ..ops import qp_ipm_structured as qps

N_OBS = 3
NAMES = ("chol", "bt", "diag", "pnone", "pref0", "pref1", "pnotopk")
DEFAULT_SPECS = ("chol:2048",)


def make_data(batch: int, seed: int = 0, device=DEFAULT_DEVICE):
    """The bench problem and (x0, x_ref, hs_h, hs_g) of `batch` QPs."""
    device = torch.device(device)
    p = get_parameters()
    A, B, C = create_double_integrator_matrices(p.dt, dtype=torch.float32,
                                                device=device)
    prob = build_mpc_problem(A, B, C, p.q_weight, p.r_weight, p.horizon,
                             N_OBS)
    H = p.horizon
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    x0 = 0.1 * torch.randn(batch, 4, **f32)
    x_ref = torch.cumsum(0.2 * torch.randn(batch, H + 1, 4, **f32), dim=1)
    hs_h = torch.randn(batch, H, N_OBS, 2, **f32)
    hs_h = hs_h / hs_h.norm(dim=-1, keepdim=True)
    hs_g = -1.5 + 1.7 * torch.rand(batch, H, N_OBS, **f32)
    return prob, (x0, x_ref, hs_h, hs_g)


def assemble(prob, x0, x_ref, hs_h, hs_g):
    """The QP batch, assembled once outside the timed region: (P_uu,
    q_u, G_u, h1, HS_u, hs_rhs, p_ss, q_s) with P_uu and G_u shared, with
    the JAX script's boxes (|u| <= 5, |p| <= 10)."""
    H, n = prob.horizon, prob.n_states
    n_u = H * prob.n_inputs
    dtype, device = prob.P.dtype, prob.P.device
    Bsz = x0.shape[0]
    phi_x0 = x0.to(dtype) @ prob.Phi.T
    e0 = phi_x0 - x_ref[:, 1:H + 1].reshape(Bsz, -1).to(dtype)
    q_u = 2.0 * prob.q_weight * (e0 @ prob.Gamma)
    pos0 = phi_x0.reshape(Bsz, H, n) @ prob.C.T
    HS_u = torch.einsum("btjd,tdn->btjn", hs_h.to(dtype),
                        prob.Theta).reshape(Bsz, H * N_OBS, n_u)
    hs_rhs = (-hs_g.to(dtype) - torch.einsum("btjd,btd->btj", hs_h.to(dtype),
                                             pos0)).reshape(Bsz, H * N_OBS)
    eye_u = torch.eye(n_u, dtype=dtype, device=device)
    Theta_flat = prob.Theta.reshape(H * prob.n_outputs, n_u)
    u_max = torch.full((n_u,), 5.0, dtype=dtype, device=device)
    p_max = torch.full((H * prob.n_outputs,), 10.0, dtype=dtype,
                       device=device)
    pos0_flat = pos0.reshape(Bsz, -1)
    G_u = torch.cat([eye_u, -eye_u, Theta_flat, -Theta_flat])
    h1 = torch.cat([u_max.expand(Bsz, -1), u_max.expand(Bsz, -1),
                    p_max - pos0_flat, p_max + pos0_flat], dim=1)
    return (prob.P[:n_u, :n_u], q_u, G_u, h1, HS_u, hs_rhs,
            2.0 * SLACK_QUAD, SLACK_LIN)


def _diag_factor(S):
    return S


def _diag_solve(L, r):
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return r / (d if r.dim() == L.dim() - 1 else d[..., None])


def _no_polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
               u, s, l1, l2, l3, w1, w2, w3):
    return u, s, l1, l2, l3, w1, w2, w3


def _first_rows(score, k: int):
    return torch.arange(k, device=score.device).expand(score.shape[0], k)


def _rebinds(name: str, polish: bool) -> dict:
    """The names of `ops/qp_ipm_structured` a variant replaces."""
    out = {}
    if name == "diag":
        out.update(_factor=_diag_factor, _solve=_diag_solve)
    if name in ("diag", "pnone") or not polish:
        out["_polish"] = _no_polish
    if name in ("pref0", "pref1"):
        out["POLISH_REFINEMENTS"] = int(name[-1])
    if name == "pnotopk":
        out["_select_rows"] = _first_rows
    return out


@contextlib.contextmanager
def variant(name: str, polish: bool = True):
    """Rebind the solver's names for variant `name`; restore them after,
    raised or not.  The cached graphs are dropped before and after, as
    they captured the names bound at their first call."""
    new = _rebinds(name, polish)
    old = {key: getattr(qps, key) for key in new}
    qps._GRAPHS.clear()
    for key, value in new.items():
        setattr(qps, key, value)
    try:
        yield
    finally:
        for key, value in old.items():
            setattr(qps, key, value)
        qps._GRAPHS.clear()


def parse_spec(spec: str) -> dict:
    """`NAME:BATCH[:ITERS][:nopol]` -> its fields."""
    parts = spec.split(":")
    if parts[0] not in NAMES or len(parts) < 2 or not parts[1].isdigit():
        raise ValueError(f"bad spec {spec!r}: expected NAME:BATCH[:ITERS]"
                         f"[:nopol] with NAME in {NAMES}")
    out = dict(spec=spec, name=parts[0], batch=int(parts[1]), iters=35,
               polish=True)
    for part in parts[2:]:
        if part == "nopol":
            out["polish"] = False
        elif part.isdigit():
            out["iters"] = int(part)
        else:
            raise ValueError(f"bad spec {spec!r}: unknown part {part!r}")
    return out


def time_chain(solve, q_u, k: int, repeats: int) -> dict:
    """Median, min and max ms a solve over `repeats` runs of `k` chained
    solves (each q_u moved by 1e-6 of the previous answer), each run
    between two `torch.cuda.synchronize()` on a card."""
    device = q_u.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        q = q_u
        for _ in range(k):
            q = q_u + 1e-6 * solve(q).u.sum(-1, keepdim=True)
        sync()
        times.append((time.perf_counter() - t0) / k * 1e3)
    return dict(ms=statistics.median(times), ms_min=min(times),
                ms_max=max(times), repeats=repeats, k=k)


def bench_variant(prob, data, batch: int, name: str, max_iters: int = 35,
                  k: int = 8, polish: bool = True,
                  repeats: int = 5) -> dict:
    """Time one variant on the first `batch` QPs of `data`."""
    qp = assemble(prob, *(d[:batch] for d in data))
    P_uu, q_u, G_u, h1, HS_u, hs_rhs, p_ss, q_s = qp
    box_theta = (prob.Theta.reshape(-1, P_uu.shape[0]) if name == "bt"
                 else None)

    def solve(q):
        return qps.solve_mpc_qp(P_uu, q, G_u, h1, HS_u, hs_rhs, p_ss, q_s,
                                max_iters=max_iters, tol=3e-5,
                                box_theta=box_theta)

    with variant(name, polish):
        sol = solve(q_u)                    # warm-up; its counts reported
        r = time_chain(solve, q_u, k, repeats)
    r.update(qp_per_s=batch / (r["ms"] * 1e-3),
             iters_mean=float(sol.iterations.float().mean()),
             iters_max=int(sol.iterations.max()),
             converged=float(sol.converged.float().mean()))
    return r


def format_line(spec: str, r: dict) -> str:
    return (f"{spec}  {r['qp_per_s']:9.1f} QP/s  {r['ms']:.3f} ms a solve "
            f"(median of {r['repeats']} x {r['k']} chained, spread "
            f"{r['ms_min']:.3f}-{r['ms_max']:.3f})  IPM iterations mean "
            f"{r['iters_mean']:.4f} max {r['iters_max']}  converged "
            f"{r['converged']:.4f}")


def run(specs=DEFAULT_SPECS, device=DEFAULT_DEVICE, repeats: int = 5,
        k: int | None = None, seed: int = 0) -> list:
    """Time every spec on one data set; returns [(spec fields, result)]."""
    parsed = [parse_spec(s) for s in specs]
    prob, data = make_data(max(p["batch"] for p in parsed), seed, device)
    out = []
    for p in parsed:
        kk = k if k is not None else min(8, max(2, 8 * 2048 // p["batch"]))
        out.append((p, bench_variant(prob, data, p["batch"], p["name"],
                                     p["iters"], kk, p["polish"], repeats)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("specs", nargs="*", default=list(DEFAULT_SPECS))
    parser.add_argument("--device", default=DEFAULT_DEVICE)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--k", type=int, default=None,
                        help="chained solves a repeat (default: 8 up to "
                             "batch 2048, fewer above, as in the JAX "
                             "script)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    out = run(args.specs, args.device, args.repeats, args.k, args.seed)
    for spec, r in out:
        print(format_line(spec["spec"], r), flush=True)
    return out


if __name__ == "__main__":
    main()
