"""PyTorch / CUDA port of the DR-CVaR safety-filtering engine.

A second package beside the JAX one
(`dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu`),
which stays the reference this port is held to.  Same subpackage layout
and function names; plain functions on tensors with an explicit device
and dtype.  `vmap` becomes a leading batch axis: the pipeline takes a
batch of scenarios `[S, ...]`.

The three Pallas kernels on the scenario pipeline's path are CUDA C++
kernels for Hopper (`ops/csrc/`), built with nvcc on first use:

  * `ops/cuda_kernels.all_metrics_halfspaces`  (all three risk metrics'
    halfspaces in one pass over the samples);
  * `ops/cuda_linalg.batched_cholesky`;
  * `ops/cuda_linalg.batched_cho_solve`.

On a CPU tensor each wrapper runs its plain PyTorch version instead; on
a CUDA tensor it launches its kernel or raises.

This package never imports jax.

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch as dct
"""

from . import config
from . import core
from . import ops
from . import simulation
from . import models
from . import convert

__version__ = "0.1.0"
