"""The plain reference of the safety filter, and the comparisons that decide
`correct`.

Written from the mathematics of the reference repository
(RJ-23YP/DR_CVaR_MPC_Safety_Filter_Motion_Planning_Collison_Avoidance:
core/risk_metrics.py's halfspace programs, core/mpc_filter.py's MPC QP,
simulation/planner.py's straight line) and arXiv:2309.08821, in plain
PyTorch. It imports nothing of the program under test and takes nothing
that the program made: the benchmark hands both sides the same obstacle
draws, and the reference works out everything else again (the straight
line, the halfspaces, the condensed QP and its optimum, the rollout, the
distances).

Every function takes an `Arith`: `FLOAT64` is the reference proper;
`TF32` is the control, the same arithmetic in float32 with the operands of
every matrix product rounded to TF32 (10 mantissa bits), the precision a
card uses for float32 products once TF32 is allowed.

The halfspace stage is judged by what its outputs say: for each row and
metric, whether the normal is the unit vector toward the right point (the
sample mean, from the ego for CVaR / DR-CVaR and from the origin for the
mean metric, the reference's quirk), and whether the offset is the closed
form's for that normal. The QP stage is judged by the program's filtered
controls in the reference's own float64 QP: their objective, with the best
slacks for them, against the optimum, and their box violation. The rollout
and distances are judged against the float64 rollout of the program's own
controls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

METRICS = ("mean", "cvar", "dr_cvar")
EPS = 1e-10          # degenerate-direction threshold (reference geometry)
SLACK_LIN = 50.0     # reference core/mpc_filter.py: 50 s + 50 s^2
SLACK_QUAD = 50.0


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool

    def mm(self, a, b):
        """a @ b, with TF32 operands in the control."""
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


FLOAT64 = Arith(torch.float64, False)
TF32 = Arith(torch.float32, True)


def round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# --- dynamics, straight line, obstacle law -------------------------------

def double_integrator(dt, ar, device):
    """(A, B, C) of the 2-D double integrator, state [p, v]."""
    eye, zero = torch.eye(2, dtype=torch.float64), torch.zeros(2, 2,
                                                               dtype=torch.float64)
    A = torch.cat([torch.cat([eye, dt * eye], 1), torch.cat([zero, eye], 1)])
    B = torch.cat([0.5 * dt * dt * eye, dt * eye])
    C = torch.cat([eye, zero], 1)
    return tuple(M.to(ar.dtype).to(device) for M in (A, B, C))


def straight_line(start, goal, velocity, dt, horizon, ar):
    """The reference planner's constant-velocity line from `start` to
    `goal` ([S, 2] each): x_ref [S, H+1, 4] with zero velocity at t = 0,
    positions start + (t / n) (goal - start) for t <= n = floor(|goal -
    start| / velocity / dt) steps and the goal after, velocity along the
    line while moving."""
    start, goal = start.to(ar.dtype), goal.to(ar.dtype)
    S = start.shape[0]
    diff = goal - start
    dist = torch.linalg.vector_norm(diff, dim=-1)
    degen = dist < EPS
    direction = diff / torch.where(degen, torch.ones_like(dist), dist)[:, None]
    n = torch.floor(dist / velocity / dt)[:, None]
    t = torch.arange(1, horizon + 1, dtype=ar.dtype, device=start.device)[None]
    moving = (t <= n)[..., None]
    pos = torch.where(moving, start[:, None] + (t / n.clamp(min=1.0))[..., None]
                      * diff[:, None], goal[:, None])
    vel = torch.where(moving, velocity * direction[:, None],
                      torch.zeros((), dtype=ar.dtype, device=start.device))
    x = torch.zeros((S, horizon + 1, 4), dtype=ar.dtype, device=start.device)
    x[:, 0, :2] = start
    x[:, 1:, :2] = pos
    x[:, 1:, 2:] = vel
    stat = torch.zeros_like(x)
    stat[..., :2] = start[:, None]
    return torch.where(degen[:, None, None], stat, x)


def line_inputs(x_ref, mats, ar):
    """The straight line's inputs, recovered as u_t = B^+ (x_{t+1} - A
    x_t) (the controls a plan falls back to): [S, H, 2]."""
    Bp = torch.linalg.pinv(mats.B)
    return ar.mm(x_ref[:, 1:] - ar.mm(x_ref[:, :-1], mats.A.T), Bp.T)


def nominal_paths(starts, directions, speeds, n_steps, dt, dtype, device):
    """Constant-velocity obstacle paths [n_obs, n_steps+1, 2]."""
    starts, directions, speeds = (torch.as_tensor(v, dtype=dtype,
                                                  device=device)
                                  for v in (starts, directions, speeds))
    norm = torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    unit = torch.where(norm < EPS, torch.zeros_like(directions),
                       directions / norm.clamp(min=EPS))
    t = torch.arange(n_steps + 1, dtype=dtype, device=device)[:, None]
    return starts[:, None] + t * dt * (speeds[:, None] * unit)[:, None]


def draw_noise(generator, shape_nominal, n_samples, noise_var, device):
    """The documented obstacle law's noise, drawn from `generator` in
    float32 on `device`: Gaussian sample noise of variance `noise_var`
    [..., n_obs, N, T+1, 2] and a Laplace realization noise of the same
    variance [..., n_obs, T+1, 2] (a difference of two Exp(1) draws, as
    the reference repository draws it); both zero at t = 0."""
    lead = tuple(shape_nominal[:-2])
    sample = torch.randn(lead + (n_samples,) + tuple(shape_nominal[-2:]),
                         generator=generator, dtype=torch.float32,
                         device=device) * math.sqrt(noise_var)
    sample[..., 0, :] = 0.0
    exp = torch.empty((2,) + tuple(shape_nominal), dtype=torch.float32,
                      device=device).exponential_(generator=generator)
    real = math.sqrt(noise_var / 2.0) * (exp[0] - exp[1])
    real[..., 0, :] = 0.0
    return sample, real


def mc_run_seeds(seed: int, n_runs: int) -> list[int]:
    """The Monte Carlo study's per-run seeds: one CPU generator seeded
    with the study's seed draws them all up front."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 62, (n_runs,), generator=gen,
                         dtype=torch.int64).tolist()


def mc_redraw(seeds, cfg, n_steps, device):
    """The obstacle noise of the Monte Carlo runs with these seeds: each
    run draws from its own card generator seeded with its seed, samples
    first. Returns float32 (sample noise [R, n_obs, N, T+1, 2],
    realization noise [R, n_obs, T+1, 2])."""
    shape = (1, len(cfg["obstacles"]), n_steps + 1, 2)
    parts = [draw_noise(torch.Generator(device=device).manual_seed(s), shape,
                        cfg["num_samples"], cfg["noise_var"], device)
             for s in seeds]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


# --- halfspaces ----------------------------------------------------------

def _normalize(v):
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    return torch.where(norm < EPS, fallback, v / norm.clamp(min=EPS))


def _cvar_neg_proj(samples, h, alpha, ar):
    """CVaR_alpha of -h . xi over the N samples of each row: with the
    values sorted from the largest and k = ceil(alpha N), (sum of the k-1
    largest + (alpha N - k + 1) x_(k)) / (alpha N)."""
    x = -ar.mm(samples, h[..., :, None])[..., 0]
    N = x.shape[-1]
    k = max(min(math.ceil(alpha * N - 1e-12), N), 1)
    top = torch.topk(x, k, dim=-1).values
    an = alpha * N
    return (top[..., :k - 1].sum(-1) + (an - k + 1) * top[..., k - 1]) / an


def offsets_for_normals(samples, mean, h, cfg, ar):
    """The closed forms' offsets for given normals h {metric: [R, 2]}:
    mean -(h . mu - r |h|); CVaR g* = CVaR(-h . xi) + r |h| - delta;
    DR-CVaR g* - r |h| with g* = CVaR + r |h| - delta + epsilon / alpha."""
    r = cfg["robot_radius"] + cfg["obstacle_radius"]
    a, d, e = cfg["alpha"], cfg["delta"], cfg["epsilon"]
    out = {}
    hm = h["mean"]
    out["mean"] = -((hm * mean).sum(-1) - r * torch.linalg.vector_norm(hm, dim=-1))
    for m in ("cvar", "dr_cvar"):
        cv = _cvar_neg_proj(samples, h[m], a, ar)
        rt = r * torch.linalg.vector_norm(h[m], dim=-1)
        out[m] = cv + rt - d if m == "cvar" else cv - d + e / a
    return out


def halfspaces(samples, ego, cfg, ar):
    """All three metrics' halfspaces of rows of samples [R, N, 2] seen
    from ego positions [R, 2]: ({metric: h [R, 2]}, {metric: g [R]})."""
    samples, ego = samples.to(ar.dtype), ego.to(ar.dtype)
    mean = samples.mean(-2)
    h_ego = _normalize(mean - ego)
    h = {"mean": _normalize(mean), "cvar": h_ego, "dr_cvar": h_ego}
    return h, offsets_for_normals(samples, mean, h, cfg, ar)


def halfspace_gap(samples, ego, h_out, g_out, cfg):
    """The widest error of given halfspaces against the float64 closed
    forms, over rows and metrics: max of | |h| - 1 |, | |c| h - c | with c
    the vector h should point along, and |g - g*(h)| with g*(h) the
    closed-form offset for the given normal (metres). Non-finite -> inf."""
    samples = samples.to(torch.float64)
    ego = ego.to(torch.float64)
    mean = samples.mean(-2)
    toward = {"mean": mean, "cvar": mean - ego, "dr_cvar": mean - ego}
    h = {m: h_out[m].to(torch.float64) for m in METRICS}
    g_ref = offsets_for_normals(samples, mean, h, cfg, FLOAT64)
    worst = torch.zeros((), dtype=torch.float64, device=samples.device)
    for m in METRICS:
        c = toward[m]
        cn = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
        errs = torch.stack([
            (torch.linalg.vector_norm(h[m], dim=-1) - 1).abs(),
            torch.linalg.vector_norm(cn * h[m] - c, dim=-1),
            (g_out[m].to(torch.float64) - g_ref[m]).abs()])
        errs = torch.where(torch.isfinite(errs), errs,
                           torch.full_like(errs, math.inf))
        worst = torch.maximum(worst, errs.max())
    return float(worst)


# --- the MPC QP ----------------------------------------------------------

class Mats(NamedTuple):
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    Phi: torch.Tensor     # [H*4, 4]
    Gamma: torch.Tensor   # [H*4, H*2]
    Theta: torch.Tensor   # [H, 2, H*2]  positions of x_1 .. x_H


def mpc_mats(cfg, ar, device):
    A, B, C = double_integrator(cfg["dt"], ar, device)
    H = cfg["horizon"]
    n, m = B.shape
    powers = [torch.eye(n, dtype=ar.dtype, device=device)]
    for _ in range(H):
        powers.append(ar.mm(A, powers[-1]))
    Phi = torch.cat(powers[1:])
    Gamma = torch.zeros((H * n, H * m), dtype=ar.dtype, device=device)
    for t in range(1, H + 1):
        for j in range(t):
            Gamma[(t - 1) * n:t * n, j * m:(j + 1) * m] = ar.mm(powers[t - 1 - j], B)
    Theta = torch.stack([ar.mm(C, Gamma[t * n:(t + 1) * n]) for t in range(H)])
    return Mats(A, B, C, Phi, Gamma, Theta)


class QP(NamedTuple):
    """min 0.5 z'P z + q'z s.t. G z <= hb, z = [u (H*2); s (H*n_obs)];
    `box` rows of G are the hard input and position boxes."""
    P: torch.Tensor       # [nz, nz]
    q: torch.Tensor       # [B, nz]
    G: torch.Tensor       # [B, rows, nz]
    hb: torch.Tensor      # [B, rows]
    const: torch.Tensor   # [B] the objective's constant q_w |e0|^2
    n_u: int
    box: int


def build_qp(x0, x_ref, hs_h, hs_g, cfg, mats, ar):
    """The reference MPC QP of a batch: x0 [B, 4], x_ref [B, H+1, 4],
    halfspaces hs_h [B, H, n_obs, 2] / hs_g [B, H, n_obs] computed at
    timestep t and constraining x_{t+1}. Tracking q_w |x_t - xref_t|^2
    for t = 1..H, effort r_w |u|^2, soft rows h.p + g <= s with 50 s +
    50 s^2, s >= 0, |u| <= input bound, |p| <= position bound."""
    dt = ar.dtype
    Bsz, H = x0.shape[0], cfg["horizon"]
    n_obs = hs_h.shape[2]
    n_u, n_s = 2 * H, H * n_obs
    qw, rw = cfg["q_weight"], cfg["r_weight"]
    Phi, Gamma, Theta = mats.Phi, mats.Gamma, mats.Theta
    phi_x0 = ar.mm(x0.to(dt), Phi.T)
    e0 = phi_x0 - x_ref[:, 1:H + 1].reshape(Bsz, -1).to(dt)
    P = torch.zeros((n_u + n_s, n_u + n_s), dtype=dt, device=x0.device)
    P[:n_u, :n_u] = 2 * (qw * ar.mm(Gamma.T, Gamma)
                         + rw * torch.eye(n_u, dtype=dt, device=x0.device))
    P[n_u:, n_u:] = 2 * SLACK_QUAD * torch.eye(n_s, dtype=dt, device=x0.device)
    q = torch.cat([2 * qw * ar.mm(e0, Gamma),
                   torch.full((Bsz, n_s), SLACK_LIN, dtype=dt,
                              device=x0.device)], 1)
    pos0 = ar.mm(phi_x0.reshape(Bsz, H, 4), mats.C.T)         # [B, H, 2]
    Tf = Theta.reshape(2 * H, n_u)
    (umin, umax), (pmin, pmax) = cfg["input_bounds"], cfg["position_bounds"]
    tile = lambda v: torch.as_tensor(v, dtype=dt, device=x0.device).repeat(H)  # noqa: E731
    eye_u = torch.eye(n_u, dtype=dt, device=x0.device)
    z_us = torch.zeros((n_u, n_s), dtype=dt, device=x0.device)
    box = torch.cat([torch.cat([eye_u, z_us], 1), torch.cat([-eye_u, z_us], 1),
                     torch.cat([Tf, z_us], 1), torch.cat([-Tf, z_us], 1)])
    p0 = pos0.reshape(Bsz, -1)
    h_box = torch.cat([tile(umax).expand(Bsz, -1), -tile(umin).expand(Bsz, -1),
                       tile(pmax) - p0, p0 - tile(pmin)], 1)
    hh = hs_h.to(dt)
    HS = ar.mm(hh.reshape(Bsz * H, n_obs, 2), Theta.repeat(Bsz, 1, 1)
               ).reshape(Bsz, H, n_obs, n_u).reshape(Bsz, n_s, n_u)
    rhs = -hs_g.to(dt).reshape(Bsz, n_s) - (hh * pos0[:, :, None]).sum(-1).reshape(Bsz, n_s)
    eye_s = torch.eye(n_s, dtype=dt, device=x0.device)
    soft = torch.cat([HS, -eye_s.expand(Bsz, n_s, n_s)], 2)
    nonneg = torch.cat([torch.zeros((n_s, n_u), dtype=dt, device=x0.device),
                        -eye_s], 1).expand(Bsz, n_s, n_u + n_s)
    G = torch.cat([box.expand(Bsz, -1, -1), soft, nonneg], 1)
    hb = torch.cat([h_box, rhs, torch.zeros((Bsz, n_s), dtype=dt,
                                            device=x0.device)], 1)
    return QP(P, q, G, hb, qw * (e0 * e0).sum(-1), n_u, box.shape[0])


def solve_qp(qp, ar, max_iter=100, tol=None, return_residual=False):
    """Mehrotra predictor-corrector interior point on the normal
    equations, batched. A lane stops (and is frozen) once its scaled
    residuals and mean complementarity are under `tol`, never takes a
    step whose factor failed or that is not finite, and returns the
    iterate with the smallest scaled residual it reached. Returns (z [B,
    nz], objective [B] with the constant), and with `return_residual` the
    lanes' scaled residual at that iterate too."""
    if tol is None:
        tol = 1e-10 if ar.dtype == torch.float64 else 1e-6
    reg = 1e-10 if ar.dtype == torch.float64 else 1e-5
    P, q, G, hb = qp.P, qp.q, qp.G, qp.hb
    Bsz, m, nz = G.shape
    Gt = G.transpose(1, 2)
    scale = 1.0 + torch.maximum(q.abs().amax(-1), hb.abs().amax(-1))
    z = q.new_zeros((Bsz, nz))
    w = torch.clamp(hb, min=1.0)
    lam = 1.0 / w
    best_z, best_res = z, torch.full((Bsz,), math.inf, dtype=q.dtype, device=q.device)
    eye = reg * torch.eye(nz, dtype=q.dtype, device=q.device)

    def mv(M, v):
        return ar.mm(M, v[..., None])[..., 0]

    def step(v, dv, frac):
        ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                            torch.full_like(v, math.inf))
        return torch.clamp(frac * ratio.amin(-1), max=1.0)[:, None]

    for _ in range(max_iter):
        rd = ar.mm(z, P) + q + mv(Gt, lam)
        rp = mv(G, z) + w - hb
        mu = (lam * w).mean(-1)
        res = torch.maximum(torch.maximum(rd.abs().amax(-1), rp.abs().amax(-1)),
                            mu) / scale
        better = res < best_res
        best_res = torch.where(better, res, best_res)
        best_z = torch.where(better[:, None], z, best_z)
        done = best_res < tol
        if bool(done.all()):
            break
        D = lam / w
        L, info = torch.linalg.cholesky_ex(P + ar.mm(Gt * D[:, None, :], G) + eye)

        def newton(rc):
            rhs = -rd - mv(Gt, D * rp - rc / w)
            dz = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            Gdz = mv(G, dz)
            return dz, -rp - Gdz, D * (rp + Gdz) - rc / w

        _, dw_a, dl_a = newton(lam * w)
        ap, ad = step(w, dw_a, 1.0), step(lam, dl_a, 1.0)
        mu_aff = ((lam + ad * dl_a) * (w + ap * dw_a)).mean(-1)
        sigma = (mu_aff / mu.clamp(min=1e-300)) ** 3
        dz, dw, dl = newton(lam * w + dl_a * dw_a - (sigma * mu)[:, None])
        ap, ad = step(w, dw, 0.99), step(lam, dl, 0.99)
        z_n, w_n, lam_n = z + ap * dz, w + ap * dw, lam + ad * dl
        finite = torch.stack([t.isfinite().all(-1) for t in (z_n, w_n, lam_n)]).all(0)
        move = (~done & (info == 0) & finite)[:, None]
        z = torch.where(move, z_n, z)
        w = torch.where(move, w_n, w)
        lam = torch.where(move, lam_n, lam)
    f = 0.5 * (ar.mm(best_z, P) * best_z).sum(-1) + (q * best_z).sum(-1) + qp.const
    if return_residual:
        return best_z, f, best_res
    return best_z, f


def plan_objective(qp, u):
    """The objective of controls u [B, n_u] in the QP, with the best
    slacks for them (s = max(0, violation) of each soft row), and their
    box violation: (f [B], box violation [B])."""
    u = u.to(qp.q.dtype)
    n_u, nb = qp.n_u, qp.box
    G_u = qp.G[:, :, :n_u]
    Gu = (G_u @ u[..., None])[..., 0]
    n_s = qp.q.shape[1] - n_u
    s = torch.relu(Gu[:, nb:nb + n_s] - qp.hb[:, nb:nb + n_s])
    P_uu = qp.P[:n_u, :n_u]
    f = (0.5 * ((u @ P_uu) * u).sum(-1) + (qp.q[:, :n_u] * u).sum(-1)
         + (SLACK_LIN * s + SLACK_QUAD * s * s).sum(-1) + qp.const)
    viol = torch.relu(Gu[:, :nb] - qp.hb[:, :nb]).amax(-1)
    return f, viol


# --- rollout and distances -----------------------------------------------

def rollout(x0, u, mats, ar):
    """x_{t+1} = A x_t + B u_t: [..., T+1, 4] from x0 [..., 4], u [..., T, 2]."""
    xs = [x0.to(ar.dtype)]
    for t in range(u.shape[-2]):
        xs.append(ar.mm(xs[-1], mats.A.T) + ar.mm(u[..., t, :].to(ar.dtype), mats.B.T))
    return torch.stack(xs, -2)


def distances(x, obstacles, cfg, mats, ar):
    """Signed distance to the nearest obstacle, min over obstacles of
    |C x_t - o_t| - r_robot - r_obs, for t = 0 .. min(T_x, T_o):
    x [..., T_x+1, 4], obstacles [..., n_obs, T_o+1, 2]."""
    n = min(x.shape[-2], obstacles.shape[-2])
    pos = ar.mm(x[..., :n, :], mats.C.T)
    d = torch.linalg.vector_norm(pos[..., None, :, :]
                                 - obstacles[..., :n, :].to(ar.dtype), dim=-1)
    return (d - cfg["robot_radius"] - cfg["obstacle_radius"]).amin(-2)


# --- the pipeline ----------------------------------------------------------

def ego_rows(x_ref, n_steps, n_obs):
    """Ego positions of the halfspace rows, ordered (scenario, t, obstacle)."""
    S = x_ref.shape[0]
    return x_ref[:, :n_steps, :2][:, :, None].expand(S, n_steps, n_obs, 2).reshape(-1, 2)


def sample_rows(samples, n_steps):
    """Rows [S*n_steps*n_obs, N, 2] of samples [S, n_obs, N, T+1, 2]."""
    S, n_obs, N = samples.shape[:3]
    return samples[..., :n_steps, :].permute(0, 3, 1, 2, 4).reshape(-1, N, 2)


class Plan(NamedTuple):
    """What the pipeline produces for S scenarios (metric axis METRICS)."""
    h: dict             # {metric: [S, n_steps, n_obs, 2]}
    g: dict             # {metric: [S, n_steps, n_obs]}
    u: torch.Tensor     # [S, 3, H, 2]
    distances: torch.Tensor   # [S, 3, T]
    reference_distance: torch.Tensor   # [S, T]


def x0_of(start, ar):
    x0 = torch.zeros((start.shape[0], 4), dtype=ar.dtype, device=start.device)
    x0[:, :2] = start.to(ar.dtype)
    return x0


def hs_for_qp(h, g, H, S, n_obs, ar, device):
    """The halfspaces as the QP takes them [S*3, H, n_obs, 2|] , padded
    past the simulation's end with inactive rows (normal [1, 0], offset
    -1e4)."""
    hs_h = torch.stack([h[m] for m in METRICS], 1).to(ar.dtype)
    hs_g = torch.stack([g[m] for m in METRICS], 1).to(ar.dtype)
    n_hs = hs_h.shape[2]
    if n_hs < H:
        pad_h = torch.zeros((S, 3, H - n_hs, n_obs, 2), dtype=ar.dtype, device=device)
        pad_h[..., 0] = 1.0
        hs_h = torch.cat([hs_h, pad_h], 2)
        hs_g = torch.cat([hs_g, torch.full((S, 3, H - n_hs, n_obs), -1e4,
                                           dtype=ar.dtype, device=device)], 2)
    return hs_h.reshape(S * 3, H, n_obs, 2), hs_g.reshape(S * 3, H, n_obs)


def pipeline(samples, realization, start, goal, cfg, ar, mats=None,
             fallback=None):
    """The whole filter for S scenarios: samples [S, n_obs, N, T+1, 2],
    realization [S, n_obs, T+1, 2], start / goal [S, 2]. `fallback` [S,
    3] (optional) marks the plans a judged program reported as not
    converged: those take the straight line's inputs, as the filter
    specifies for a QP that did not converge."""
    device = samples.device
    mats = mats or mpc_mats(cfg, ar, device)
    H = cfg["horizon"]
    S, n_obs = samples.shape[:2]
    x_ref = straight_line(start, goal, cfg["ego_velocity"], cfg["dt"], H, ar)
    n_steps = min(H + 1, H, samples.shape[-2])
    h, g = halfspaces(sample_rows(samples, n_steps),
                      ego_rows(x_ref, n_steps, n_obs), cfg, ar)
    h = {m: v.reshape(S, n_steps, n_obs, 2) for m, v in h.items()}
    g = {m: v.reshape(S, n_steps, n_obs) for m, v in g.items()}
    x0 = x0_of(start, ar)
    hs_h, hs_g = hs_for_qp(h, g, H, S, n_obs, ar, device)
    qp = build_qp(x0.repeat_interleave(3, 0), x_ref.repeat_interleave(3, 0),
                  hs_h, hs_g, cfg, mats, ar)
    z, _ = solve_qp(qp, ar)
    u = z[:, :qp.n_u].reshape(S, 3, H, 2)
    if fallback is not None:
        u = torch.where(fallback.to(device)[..., None, None],
                        line_inputs(x_ref, mats, ar)[:, None], u)
    x = rollout(x0[:, None].expand(S, 3, 4), u, mats, ar)
    real = realization.to(ar.dtype)
    return Plan(h, g, u, distances(x, real[:, None], cfg, mats, ar),
                distances(x_ref, real, cfg, mats, ar))


def judge_plan(plan, samples, realization, start, goal, cfg, fallback=None):
    """The three numbers of a pipeline's outputs for S scenarios against
    the float64 reference: halfspace_gap (see `halfspace_gap`), plan_gap
    (the widest of |f(u) - f*| / max(1, |f*|) and the box violation of the
    controls u, f in the reference's QP with the best slacks for u) and
    distance_gap (|d - d_ref| with d_ref the float64 rollout of the same
    controls against the realization). A plan the program reported as
    fallen back (`fallback` [S, 3], counted as failed by the harness) is
    judged by what it says: its controls against the straight line's
    inputs, max |u - u_line|, in plan_gap."""
    ar = FLOAT64
    device = samples.device
    mats = mpc_mats(cfg, ar, device)
    H = cfg["horizon"]
    S, n_obs = samples.shape[:2]
    x_ref = straight_line(start, goal, cfg["ego_velocity"], cfg["dt"], H, ar)
    n_steps = min(H, samples.shape[-2])
    rows, ego = sample_rows(samples, n_steps).to(ar.dtype), ego_rows(x_ref, n_steps, n_obs)
    flat = lambda t: t.reshape(S * n_steps * n_obs, *t.shape[3:])  # noqa: E731
    hs_gap = halfspace_gap(rows, ego, {m: flat(plan.h[m]) for m in METRICS},
                           {m: flat(plan.g[m]) for m in METRICS}, cfg)
    h_ref, g_ref = halfspaces(rows, ego, cfg, ar)
    h_ref = {m: v.reshape(S, n_steps, n_obs, 2) for m, v in h_ref.items()}
    g_ref = {m: v.reshape(S, n_steps, n_obs) for m, v in g_ref.items()}
    x0 = x0_of(start, ar)
    hs_h, hs_g = hs_for_qp(h_ref, g_ref, H, S, n_obs, ar, device)
    qp = build_qp(x0.repeat_interleave(3, 0), x_ref.repeat_interleave(3, 0),
                  hs_h, hs_g, cfg, mats, ar)
    _, f_star = solve_qp(qp, ar)
    u = plan.u.reshape(S * 3, -1).to(ar.dtype)
    f_u, viol = plan_objective(qp, u)
    gap = torch.maximum((f_u - f_star).abs() / f_star.abs().clamp(min=1.0), viol)
    if fallback is not None:
        line = line_inputs(x_ref, mats, ar)[:, None].expand(S, 3, H, 2)
        off = (u.reshape(S, 3, H, 2) - line).abs().amax((-1, -2)).reshape(-1)
        gap = torch.where(fallback.reshape(-1).to(device), off, gap)
    plan_gap = float(torch.where(torch.isfinite(gap), gap,
                                 torch.full_like(gap, math.inf)).max())
    x = rollout(x0[:, None].expand(S, 3, 4), plan.u.to(ar.dtype), mats, ar)
    d_ref = distances(x, realization.to(ar.dtype)[:, None], cfg, mats, ar)
    dd = (plan.distances.to(ar.dtype) - d_ref).abs()
    dist_gap = float(torch.where(torch.isfinite(dd), dd,
                                 torch.full_like(dd, math.inf)).max())
    return {"halfspace_gap": hs_gap, "plan_gap": plan_gap,
            "distance_gap": dist_gap}


def min_distances(plan):
    """Per-run minimum distance over time: [S, 4] (METRICS, then the
    unfiltered reference), as the Monte Carlo study reports it."""
    return torch.cat([plan.distances.amin(-1),
                      plan.reference_distance.amin(-1)[:, None]], 1)
