"""A Monte Carlo chunk's obstacle draws on one hand-written CUDA kernel.

`simulation/obstacles.py::draw_runs_kernel` draws every run of a chunk
in one launch of `obstacle_draws`, where `draw_runs_loop` makes one card
generator a run and draws from it with `torch.randn` and `exponential_`.
The kernel replays, bit for bit, what those two calls compute from each
run's generator (`torch.Generator(device="cuda").manual_seed(seed)`):
its Philox4x32-10 stream, the launch geometry PyTorch gives the two
draws on this card (`philox_plan`), curand's transforms and the loop's
float32 operations.  The source is `csrc/obstacle_draws.cu`; its header
says what PyTorch computes and how the kernel replays it.

The wrapper takes CUDA float32 tensors only and raises on anything else
(no fallback); which draws take it is
`evaluation/monte_carlo.py::use_draw_kernel`'s choice.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build

BLOCK = 256     # threads a block of PyTorch's distribution kernels
UNROLL = 4      # float32 values a thread takes from one Philox block


def philox_plan(numel: int, sm_count: int, threads_per_sm: int
                ) -> tuple[int, int]:
    """(threads, rounds) of PyTorch's launch of a float32 `normal_` or
    `exponential_` over `numel` contiguous elements on a card with
    `sm_count` multiprocessors of `threads_per_sm` threads: the grid holds
    min(ceil(numel / 256), sm_count x (threads_per_sm / 256)) blocks of
    256, and each thread draws `rounds` Philox blocks, so the generator's
    offset moves on by 4 x rounds.  Read from, and probed on the card
    against, torch 2.11.0+cu128's DistributionTemplates.h; a torch whose
    launch differs fails `simulation/obstacles.py::_check_first_run`."""
    blocks = min(-(-numel // BLOCK), sm_count * (threads_per_sm // BLOCK))
    threads = BLOCK * blocks
    return threads, (numel - 1) // (threads * UNROLL) + 1


@functools.cache
def _card(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def obstacle_draws(nominal, seeds, n_samples: int, noise_var: float):
    """Every run's draws around the nominal paths, one run a seed.

    nominal [n_obs, T+1, 2] float32 and seeds [S] int64 (each in
    [0, 2^63)) on one CUDA device.  Returns (nominal [S, n_obs, T+1, 2],
    samples [S, n_obs, n_samples, T+1, 2], realization [S, n_obs, T+1,
    2]): run r's as `draw_runs_loop` draws them from a card generator
    seeded with seeds[r]."""
    if nominal.device.type != "cuda" or nominal.dtype != torch.float32:
        raise ValueError(f"nominal: expected a float32 CUDA tensor, got "
                         f"{nominal.dtype} on {nominal.device}")
    if nominal.dim() != 3 or nominal.shape[-1] != 2:
        raise ValueError(f"nominal: expected [n_obs, T+1, 2], got "
                         f"{tuple(nominal.shape)}")
    if (seeds.device != nominal.device or seeds.dtype != torch.int64
            or seeds.dim() != 1):
        raise ValueError(f"seeds: expected int64 [S] on {nominal.device}")
    nominal, seeds = nominal.contiguous(), seeds.contiguous()
    n_obs, steps, _ = nominal.shape
    S = seeds.shape[0]
    per_run = n_obs * n_samples * steps * 2
    if per_run >= 2 ** 31:
        raise ValueError(f"a run of {per_run} sample floats: PyTorch splits "
                         f"such a draw, which the kernel does not replay")
    device = nominal.device
    f32 = dict(dtype=torch.float32, device=device)
    nominal_out = torch.empty(S, n_obs, steps, 2, **f32)
    samples = torch.empty(S, n_obs, n_samples, steps, 2, **f32)
    realization = torch.empty(S, n_obs, steps, 2, **f32)
    if S == 0:
        return nominal_out, samples, realization
    card = _card(device.index if device.index is not None
                 else torch.cuda.current_device())
    threads_s, rounds_s = philox_plan(per_run, *card)
    threads_e, _ = philox_plan(2 * n_obs * steps * 2, *card)
    _build.launch("drcvar_obstacle_draws", device, nominal.data_ptr(),
                  seeds.data_ptr(), nominal_out.data_ptr(),
                  samples.data_ptr(), realization.data_ptr(), S, n_obs,
                  n_samples, steps, threads_s, threads_e, rounds_s,
                  math.sqrt(noise_var), math.sqrt(noise_var / 2.0))
    obstacle_draws.launches += 1
    return nominal_out, samples, realization


obstacle_draws.launches = 0
