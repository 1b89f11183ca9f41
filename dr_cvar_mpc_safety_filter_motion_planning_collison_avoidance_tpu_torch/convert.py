"""Carries state between the JAX package and this port.

The JAX package's objects arrive as numpy arrays (or anything
`np.asarray` takes, such as a JAX array, so no JAX import is needed):
`ObstacleData` and `MPCProblem`'s arrays and scalars (an `MPCResult`
goes back only).  They become the
port's objects on a given device and dtype; the `*_numpy` functions go
back.  The parity tests hand both implementations identical data this
way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .config.parameters import DEFAULT_DEVICE
from .models.mpc_filter import MPCProblem, MPCResult
from .simulation.obstacles import ObstacleData

MPC_ARRAYS = ("A", "B", "C", "Phi", "Gamma", "Theta", "P")
MPC_SCALARS = ("horizon", "n_states", "n_inputs", "n_outputs",
               "n_obstacles", "q_weight", "r_weight")


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def obstacle_data(src, dtype=torch.float32, device=DEFAULT_DEVICE,
                  add_batch: bool = False) -> ObstacleData:
    """ObstacleData from arrays with fields nominal / samples /
    realization.  `add_batch` prepends the scenario axis of size 1 (the
    JAX package's single-scenario layout has none)."""
    def conv(name):
        t = torch.as_tensor(np.array(_field(src, name)), dtype=dtype,
                            device=device)
        return t[None] if add_batch else t
    return ObstacleData(*(conv(f) for f in ObstacleData._fields))


def obstacle_data_numpy(obs: ObstacleData) -> dict:
    return {f: getattr(obs, f).detach().cpu().numpy()
            for f in ObstacleData._fields}


def mpc_problem(src, dtype=torch.float32, device=DEFAULT_DEVICE) -> MPCProblem:
    """MPCProblem from the JAX problem's arrays and scalars."""
    arrays = {f: torch.as_tensor(np.array(_field(src, f)), dtype=dtype,
                                 device=device) for f in MPC_ARRAYS}
    scalars = {f: _field(src, f) for f in MPC_SCALARS}
    return MPCProblem(**arrays, **scalars)


def mpc_problem_numpy(prob: MPCProblem) -> dict:
    out = {f: getattr(prob, f).detach().cpu().numpy() for f in MPC_ARRAYS}
    out.update({f: getattr(prob, f) for f in MPC_SCALARS})
    return out


def mpc_result_numpy(res: MPCResult) -> dict:
    """An MPCResult (one trajectory or a batch) as numpy arrays."""
    return {f: getattr(res, f).detach().cpu().numpy()
            for f in MPCResult._fields}
