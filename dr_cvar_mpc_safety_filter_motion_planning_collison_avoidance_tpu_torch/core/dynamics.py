"""Discrete-time LTI dynamics (double / single integrator) and rollouts.

Port of the JAX package's core/dynamics.py.  `lax.scan` becomes a Python
loop over the horizon; every function takes leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.parameters import DEFAULT_DEVICE


def create_double_integrator_matrices(dt: float, dim: int = 2,
                                      dtype=torch.float32, device=DEFAULT_DEVICE):
    """State-space matrices of a discrete double integrator.

    State [p, v] in R^{2*dim}.  Returns (A, B, C) with A: [2d,2d],
    B: [2d,d], C: [d,2d].
    """
    eye = np.eye(dim)
    zeros = np.zeros((dim, dim))
    A = np.block([[eye, dt * eye], [zeros, eye]])
    B = np.block([[0.5 * dt**2 * eye], [dt * eye]])
    C = np.block([eye, zeros])
    return tuple(torch.as_tensor(M, dtype=dtype, device=device)
                 for M in (A, B, C))


def create_single_integrator_matrices(dt: float, dim: int = 2,
                                      dtype=torch.float32, device=DEFAULT_DEVICE):
    """Single-integrator matrices (A = I, B = dt I, C = I)."""
    eye = np.eye(dim)
    return tuple(torch.as_tensor(M, dtype=dtype, device=device)
                 for M in (eye, dt * eye, eye))


def simulate_linear_system(x0, u_sequence, A, B, C):
    """Roll out x_{t+1} = A x_t + B u_t and y_t = C x_t.

    Shapes: x0 [..., n], u_sequence [..., T, m] -> ([..., T+1, n],
    [..., T+1, p]).  The loop runs over the horizon; the batch axes ride
    along in every step.
    """
    xs = [x0]
    for t in range(u_sequence.shape[-2]):
        xs.append(xs[-1] @ A.T + u_sequence[..., t, :] @ B.T)
    x_sequence = torch.stack(xs, dim=-2)
    return x_sequence, x_sequence @ C.T


def condensed_dynamics(A, B, horizon: int):
    """Condensed prediction matrices for X = Phi x0 + Gamma U.

    X = [x_1; ...; x_H], U = [u_0; ...; u_{H-1}].  Phi: [H*n, n],
    Gamma: [H*n, H*m] block-lower-triangular with Gamma[t, j] =
    A^{t-1-j} B for j < t.

    Computed in float64 numpy on the host, then cast to A's dtype and
    device, as the JAX package does.
    """
    A_np = A.detach().cpu().double().numpy()
    B_np = B.detach().cpu().double().numpy()
    n, m = B_np.shape
    H = horizon

    powers = [np.eye(n)]
    for _ in range(H):
        powers.append(A_np @ powers[-1])

    Phi = np.concatenate([powers[t] for t in range(1, H + 1)], axis=0)
    Gamma = np.zeros((H * n, H * m))
    for t in range(1, H + 1):
        for j in range(t):
            Gamma[(t - 1) * n:t * n, j * m:(j + 1) * m] = \
                powers[t - 1 - j] @ B_np
    return (torch.as_tensor(Phi, dtype=A.dtype, device=A.device),
            torch.as_tensor(Gamma, dtype=A.dtype, device=A.device))
