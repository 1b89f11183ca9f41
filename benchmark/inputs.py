"""What the drivers share: the record of one timed call, the obstacle pools
made on the device from the seed, and the program's outputs in the form
the reference judges.

The pools follow the configuration's documented obstacle law
(reference.draw_noise: Gaussian samples, a Laplace realization), drawn by
one card generator seeded from the run's seed, a few scenarios a call.
"""

from __future__ import annotations

from typing import NamedTuple

import reference as ref


class Record(NamedTuple):
    units: float        # units of work the call completed (scenarios, rows)
    failed: float       # of which failed
    latency_s: float    # from the call until its result was on the host
    keep: object        # what the output check needs of this call


class Pool(NamedTuple):
    """P draws of S scenarios each, stacked on one scenario axis:
    nominal [P*S, n_obs, T+1, 2], samples [P*S, n_obs, N, T+1, 2] and
    realization [P*S, n_obs, T+1, 2], float32 on the device."""
    nominal: object
    samples: object
    realization: object
    per_draw: int

    def draw(self, i):
        """The i-th draw's (nominal, samples, realization) views."""
        s = slice(i * self.per_draw, (i + 1) * self.per_draw)
        return self.nominal[s], self.samples[s], self.realization[s]


def n_steps(cfg) -> int:
    return int(cfg["sim_time"] / cfg["dt"])


def make_pool(torch, cfg, draws: int, per_draw: int, seed: int, device,
              block: int = 256) -> Pool:
    """`draws` x `per_draw` obstacle draws of the configuration's
    scenario, on `device`, from one generator seeded with `seed`."""
    obs = cfg["obstacles"]
    T = n_steps(cfg)
    nominal64 = ref.nominal_paths([o["start"] for o in obs],
                                  [o["direction"] for o in obs],
                                  [o["speed"] for o in obs], T, cfg["dt"],
                                  torch.float64, device)
    nominal = nominal64.to(torch.float32)
    total = draws * per_draw
    gen = torch.Generator(device=device).manual_seed(seed)
    samples = torch.empty((total, len(obs), cfg["num_samples"], T + 1, 2),
                          dtype=torch.float32, device=device)
    real = torch.empty((total, len(obs), T + 1, 2), dtype=torch.float32,
                       device=device)
    for start in range(0, total, block):
        n = min(block, total - start)
        noise, lap = ref.draw_noise(gen, (n,) + tuple(nominal.shape),
                                    cfg["num_samples"], cfg["noise_var"], device)
        samples[start:start + n] = noise.add_(nominal[:, None])
        real[start:start + n] = lap.add_(nominal)
        del noise, lap
    return Pool(nominal.expand((total,) + tuple(nominal.shape)), samples, real,
                per_draw)


def plan_of(result, metrics=ref.METRICS):
    """A ScenarioResult of the program as a reference.Plan."""
    hs = result.halfspaces
    return ref.Plan({m: hs.by_metric(m).h for m in metrics},
                    {m: hs.by_metric(m).g_tilde for m in metrics},
                    result.filtered_u, result.distances,
                    result.reference_distance)


def bad_scenarios(torch, result):
    """Per scenario: a QP fell back, or an output is not finite."""
    S = result.filtered_u.shape[0]
    finite = (torch.isfinite(result.filtered_u).reshape(S, -1).all(1)
              & torch.isfinite(result.distances).reshape(S, -1).all(1))
    return result.used_fallback.any(1) | ~finite


def start_goal(torch, cfg, S, device):
    """The scenario's ego start and goal as [S, 2] float64 tensors."""
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)  # noqa: E731
    return (as_t(cfg["ego_start"]).expand(S, 2), as_t(cfg["ego_goal"]).expand(S, 2))


def cat_plans(torch, plans):
    """Plans of several calls as one, on the scenario axis."""
    return ref.Plan({m: torch.cat([p.h[m] for p in plans]) for m in plans[0].h},
                    {m: torch.cat([p.g[m] for p in plans]) for m in plans[0].g},
                    torch.cat([p.u for p in plans]),
                    torch.cat([p.distances for p in plans]),
                    torch.cat([p.reference_distance for p in plans]))
