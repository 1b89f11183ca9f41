"""The reference's seed-42 obstacle streams, in numpy only.

A numpy-only copy of `test_reference_parity.reference_rng_obstacles`
(that module imports jax), shared by the PyTorch port's tests and by
`chip_smoke.py`, which runs where there is no jax.  The reference seeds
numpy's legacy global generator with 42 and draws, per obstacle, the
sample trajectories first (one multivariate normal per step) and then
the Laplace realization (two exponentials per step); legacy streams are
stable, so the draws are the reference's own.  `oracle_controls` solves
the pipeline's QP with the scipy oracle of tests/oracle.py, and
`adversarial_samples` makes the all-metrics kernel's edge-case rows.
"""

from __future__ import annotations

import numpy as np

# (preset, scenario) pairs of the port's end-to-end checks: the four
# custom scenarios and the paper head_on, whose sim_time (3 s) is
# shorter than the horizon (6 s), so it takes the padding path.
E2E_CASES = (("custom", "head_on"), ("custom", "overtaking"),
             ("custom", "intersection"), ("custom", "multi_obstacle"),
             ("paper", "head_on"))


def reference_rng_obstacles(scenario, sim_time, dt, n_samples, seed=42):
    """Dict of numpy arrays: nominal [n_obs, T+1, 2], samples
    [n_obs, n_samples, T+1, 2], realization [n_obs, T+1, 2]."""
    np.random.seed(seed)
    n_steps = int(sim_time / dt)
    noise_cov = np.diag([0.01, 0.01])
    scale = np.sqrt(np.diag(noise_cov) / 2)

    nominals, samples_all, reals = [], [], []
    for i in range(scenario.n_obstacles):
        start = scenario.obstacle_starts[i]
        direction = scenario.obstacle_directions[i]
        speed = scenario.obstacle_speeds[i]
        d = direction / np.linalg.norm(direction)
        nominal = (start[None, :]
                   + np.arange(n_steps + 1)[:, None] * dt * speed * d)
        nominals.append(nominal)

        samples = np.zeros((n_samples, n_steps + 1, 2))
        samples[:, 0, :] = nominal[0]
        for t in range(1, n_steps + 1):
            noise = np.random.multivariate_normal(
                mean=np.zeros(2), cov=noise_cov, size=n_samples)
            samples[:, t, :] = nominal[t] + noise
        samples_all.append(samples)

        real = np.zeros_like(nominal)
        real[0] = nominal[0]
        for t in range(1, n_steps + 1):
            u1 = np.random.exponential(scale=1.0, size=2)
            u2 = np.random.exponential(scale=1.0, size=2)
            real[t] = nominal[t] + scale * (u1 - u2)
        reals.append(real)

    return {"nominal": np.stack(nominals),
            "samples": np.stack(samples_all),
            "realization": np.stack(reals)}


def adversarial_samples(case, rng, B, N):
    """[B, N, 2] sample rows: the cases of
    tests/test_evaluation.py::test_pallas_select_adversarial_data (ties,
    constant, outlier, negative, laplace), `near_ego` (values O(1e-3)
    around 5.0, the closest-approach cancellation) or Gaussian."""
    if case == "ties":
        return rng.choice(np.asarray([-1.0, 0.0, 0.25, 2.0], np.float32),
                          size=(B, N, 2))
    if case == "constant":
        return np.broadcast_to(rng.normal(size=(B, 1, 2)), (B, N, 2)).copy()
    if case == "outlier":
        vals = 0.01 * rng.normal(size=(B, N, 2))
        vals[:, 0, :] = 500.0
        return vals
    if case == "negative":
        return -10.0 + 0.1 * rng.normal(size=(B, N, 2))
    if case == "laplace":
        return rng.laplace(scale=0.5, size=(B, N, 2))
    if case == "near_ego":
        return 5.0 + 1e-3 * rng.normal(size=(B, N, 2))
    return rng.normal(size=(B, N, 2))


def double_integrator(dt):
    """(A, B, C) of the planar double integrator, numpy float64."""
    A = np.eye(4)
    A[0, 2] = A[1, 3] = dt
    B = np.zeros((4, 2))
    B[0, 0] = B[1, 1] = 0.5 * dt ** 2
    B[2, 0] = B[3, 1] = dt
    C = np.zeros((2, 4))
    C[0, 0] = C[1, 1] = 1.0
    return A, B, C


def oracle_controls(params, scenario, x_ref, halfspaces):
    """Controls [H, 2] of `oracle.mpc_qp_oracle` (scipy) per metric, for
    the pipeline's QP on the given float64 halfspaces, as
    tests/test_e2e_control_deviation.py solves it.

    x_ref [H+1, 4]; halfspaces {metric: (h [H, n_obs, 2], g [H, n_obs])}.
    """
    from oracle import mpc_qp_oracle

    A, B, C = double_integrator(params.dt)
    x0 = np.zeros(4)
    x0[:2] = scenario.ego_start
    u_max, p_max = np.array([5.0, 5.0]), np.array([10.0, 10.0])
    return {metric: mpc_qp_oracle(A, B, C, params.q_weight, params.r_weight,
                                  params.horizon, x0, x_ref, h, g, -u_max,
                                  u_max, -p_max, p_max)[0]
            for metric, (h, g) in halfspaces.items()}
