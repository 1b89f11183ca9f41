from . import mpc_filter
from . import planner
from . import pipeline
from .mpc_filter import (MPCProblem, MPCResult, build_mpc_problem,
                         filter_core_batched, filter_trajectory)
from .planner import Planner, plan_trajectory, straight_line_trajectory
from .pipeline import (METRICS, PipelineStatics, ScenarioResult,
                       make_statics, run_scenario_core,
                       run_scenario_with_obstacles, run_single_scenario)
