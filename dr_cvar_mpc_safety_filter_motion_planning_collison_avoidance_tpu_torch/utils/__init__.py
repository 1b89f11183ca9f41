from . import timing
from .timing import (Timer, timeit, time_blocked, TimingStats, trace,
                     annotate, block_until_ready)
