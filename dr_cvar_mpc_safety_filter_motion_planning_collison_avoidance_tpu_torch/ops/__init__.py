from . import halfspace
from . import cuda_draws
from . import cuda_ipm
from . import cuda_kernels
from . import cuda_linalg
from . import cuda_variants
from . import native_qp
from . import qp_ipm
from . import qp_ipm_structured
from .halfspace import (Halfspace, mean_halfspace, cvar_halfspace,
                        dr_cvar_halfspace, cvar_g_star, dr_cvar_g_star)
from .cuda_kernels import all_metrics_halfspaces, fused_drcvar_halfspace
from .cuda_linalg import batched_cho_solve, batched_cholesky
from .qp_ipm import QPSolution, solve_qp, solve_qp_batched
from .qp_ipm_structured import MPCQPSolution, solve_mpc_qp
