from . import obstacles
from . import environment
from .obstacles import ObstacleData, generate_obstacle_scenarios
from .environment import (Environment, SafeHalfspaces,
                          compute_safe_halfspaces_for_trajectory,
                          compute_distance_to_collision)
