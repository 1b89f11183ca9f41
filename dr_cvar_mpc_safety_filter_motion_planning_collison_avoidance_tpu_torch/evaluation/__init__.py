from . import metrics
from . import monte_carlo
from . import timing_analysis
from .metrics import collision_rate, expectation_of_shortfall, safety_metrics
from .monte_carlo import (MonteCarloResult, load_mc_result, print_mc_summary,
                          run_monte_carlo_simulation, save_mc_result)
from .timing_analysis import (analyze_dr_cvar_computation_time,
                              load_timing_data, save_timing_data)
