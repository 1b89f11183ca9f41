from . import dynamics
from . import geometry
from . import risk
from .dynamics import (create_double_integrator_matrices,
                       create_single_integrator_matrices,
                       simulate_linear_system, condensed_dynamics)
from .geometry import (support_function_circle, compute_separating_vector,
                       signed_distance)
from .risk import cvar_from_kth, cvar_rockafellar, kth_largest
