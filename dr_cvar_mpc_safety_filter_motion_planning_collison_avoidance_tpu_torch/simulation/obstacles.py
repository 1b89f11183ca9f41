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

Monte Carlo runs draw one generator a run, seeded with the run's seed:
`draw_runs_loop` makes each run's generator and draws from it, and on a
CUDA float32 chunk `draw_runs_kernel` writes the same numbers, bit for
bit, in one launch (`ops/cuda_draws.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cuda_draws import obstacle_draws
from ..utils import timing
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


def draw_runs_loop(seeds, starts, directions, speeds, n_steps: int,
                   dt: float, n_samples: int, noise_var: float
                   ) -> ObstacleData:
    """One draw a run, stacked on the scenario axis: run r's from a
    generator on the tensors' device seeded with seeds[r]."""
    draws = [generate_obstacle_scenarios(
        torch.Generator(device=starts.device).manual_seed(s), starts,
        directions, speeds, n_steps, dt, n_samples, noise_var, 1)
        for s in seeds]
    return ObstacleData(*(torch.cat(parts) for parts in zip(*draws)))


# (device, n_obs, n_samples, n_steps) of the kernel's draws already held
# to the loop in this process (`_check_first_run`).
_CHECKED: set = set()


def draw_runs_kernel(seeds, starts, directions, speeds, n_steps: int,
                     dt: float, n_samples: int, noise_var: float
                     ) -> ObstacleData:
    """`draw_runs_loop`'s draws, bit for bit, from CUDA float32 tensors:
    the nominal paths once, then every run in one launch of
    `ops/cuda_draws.py::obstacle_draws`.  The first call of a process at
    each shape also draws its first run by the loop and raises if the
    two differ (`_check_first_run`)."""
    seeds = list(seeds)
    with annotate("obstacles.generate"):
        nominal = generate_nominal_trajectories(starts, directions, speeds,
                                                n_steps, dt)
        out = ObstacleData(*obstacle_draws(
            nominal, torch.tensor(seeds, dtype=torch.int64,
                                  device=starts.device),
            n_samples, noise_var))
    key = (starts.device, starts.shape[0], n_samples, n_steps)
    if seeds and key not in _CHECKED:
        _check_first_run(out, seeds[:1], starts, directions, speeds,
                         n_steps, dt, n_samples, noise_var)
        _CHECKED.add(key)
    return out


def _check_first_run(out: ObstacleData, first, starts, directions, speeds,
                     n_steps, dt, n_samples, noise_var) -> None:
    """Raise unless run 0 of the kernel's draws `out` equals, bit for bit,
    the loop's draw from seed `first[0]`.  The kernel replays PyTorch's
    own distribution kernels (their launch geometry, Philox offsets and
    transforms; `ops/cuda_draws.py::philox_plan`), and a PyTorch whose
    kernels draw otherwise fails here, once a shape and process, with the
    recorder off."""
    was = timing.record(False)
    try:
        want = draw_runs_loop(first, starts, directions, speeds, n_steps,
                              dt, n_samples, noise_var)
    finally:
        timing.record(was)
    for name, a, b in zip(out._fields, out, want):
        if not torch.equal(a[:1].view(torch.int32), b.view(torch.int32)):
            raise RuntimeError(
                f"the draw kernel's {name} of seed {first[0]} differs from "
                f"the card generator's under torch {torch.__version__}: "
                f"PyTorch's distribution kernels no longer draw as "
                f"ops/csrc/obstacle_draws.cu replays them")
