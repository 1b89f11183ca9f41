"""Obstacle trajectory generation (nominal / Gaussian samples / Laplace
realization), batched over scenarios.

Port of the JAX package's simulation/obstacles.py.  Every draw takes an
explicit `torch.Generator` on the target device.  Distributional
contract (the reference's):

  * nominal: constant-velocity rollout of speed * normalize(direction);
    stationary when ||direction|| < 1e-10.
  * samples: nominal + i.i.d. N(0, noise_var) per (sample, t >= 1); all
    samples share the exact start position.
  * realization: nominal + i.i.d. Laplace noise of scale sqrt(var/2)
    per t >= 1 (a different law than the planner's Gaussian belief, with
    the same variance), drawn as a difference of two Exp(1) draws as the
    reference does.

Torch's generators do not reproduce JAX's threefry streams; parity
tests inject the same obstacle data into both implementations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.timing import annotate

_EPS = 1e-10


class ObstacleData(NamedTuple):
    """Stacked obstacle trajectories of a batch of scenario draws.

    nominal:      [S, n_obs, T+1, 2]
    samples:      [S, n_obs, n_samples, T+1, 2]
    realization:  [S, n_obs, T+1, 2]
    """

    nominal: torch.Tensor
    samples: torch.Tensor
    realization: torch.Tensor


def generate_nominal_trajectories(starts, directions, speeds, n_steps: int,
                                  dt: float):
    """Constant-velocity nominal trajectories [..., n_obs, n_steps+1, 2]."""
    norm = torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    degen = norm < _EPS
    unit = torch.where(degen, torch.zeros_like(directions),
                       directions / torch.where(degen, torch.ones_like(norm),
                                                norm))
    vel = speeds[..., None] * unit                            # [..., n_obs, 2]
    t = torch.arange(n_steps + 1, dtype=starts.dtype,
                     device=starts.device)[:, None]
    return starts[..., None, :] + t * dt * vel[..., None, :]


def generate_sample_trajectories(generator, nominal, n_samples: int,
                                 noise_var: float):
    """Gaussian sample trajectories [..., n_obs, n_samples, T+1, 2]."""
    shape = nominal.shape[:-2] + (n_samples,) + nominal.shape[-2:]
    noise = torch.randn(shape, generator=generator, dtype=nominal.dtype,
                        device=nominal.device) * math.sqrt(noise_var)
    noise[..., 0, :] = 0.0
    return nominal[..., None, :, :] + noise


def generate_laplace_realizations(generator, nominal, noise_var: float):
    """Laplace-noised realizations shaped like `nominal`."""
    exp = torch.empty((2,) + nominal.shape, dtype=nominal.dtype,
                      device=nominal.device).exponential_(generator=generator)
    noise = math.sqrt(noise_var / 2.0) * (exp[0] - exp[1])
    noise[..., 0, :] = 0.0
    return nominal + noise


def generate_obstacle_scenarios(generator, starts, directions, speeds,
                                n_steps: int, dt: float, n_samples: int,
                                noise_var: float = 0.01,
                                n_scenarios: int = 1) -> ObstacleData:
    """`n_scenarios` independent draws of one scenario's obstacles.

    starts/directions [n_obs, 2] and speeds [n_obs] are tensors on the
    generator's device; n_steps = int(sim_time / dt).
    """
    with annotate("obstacles.generate"):
        nominal = generate_nominal_trajectories(starts, directions, speeds,
                                                n_steps, dt)
        nominal = nominal.expand((n_scenarios,) + nominal.shape).contiguous()
        samples = generate_sample_trajectories(generator, nominal, n_samples,
                                               noise_var)
        realization = generate_laplace_realizations(generator, nominal,
                                                    noise_var)
    return ObstacleData(nominal, samples, realization)
