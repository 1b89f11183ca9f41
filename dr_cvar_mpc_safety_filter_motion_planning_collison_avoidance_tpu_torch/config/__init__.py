from .parameters import DEFAULT_DEVICE, Parameters, CUSTOM, PAPER, PRESETS, get_parameters
from .scenarios import Scenario, SCENARIO_NAMES, get_scenario_config

__all__ = [
    "Parameters", "CUSTOM", "PAPER", "PRESETS", "get_parameters",
    "Scenario", "SCENARIO_NAMES", "get_scenario_config",
]
