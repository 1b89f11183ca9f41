from . import mpc_filter
from . import planner
from . import pipeline
from .mpc_filter import MPCProblem, build_mpc_problem
from .planner import Planner, straight_line_trajectory
from .pipeline import (METRICS, PipelineStatics, ScenarioResult,
                       make_statics, run_scenario_core,
                       run_scenario_with_obstacles, run_single_scenario)
