from . import timing
from . import math_utils
from .timing import Timer, time_blocked, trace, annotate, block_until_ready
from .math_utils import (normalize_vector, is_point_in_halfspace,
                         project_point_to_halfspace)
