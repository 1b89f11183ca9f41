"""halfspace_block_roofline: `halfspace_roofline`'s reading (the
halfspace stage's least time, roofline.halfspace_work, over all device
time in the stage's range) in the cells that report scenarios_per_s,
where the stage runs inside the whole pipeline; named as a roofline
share's name ends. In the cell that lists it, every row of the stage
takes kernel 1's block path (halfspace_block_pct)."""

import dataclasses
from pathlib import Path

import harness

_base = harness._load_module(Path(__file__).with_name("halfspace_roofline.py"),
                             "bench_metric_halfspace_roofline_of_block")
HOOKS = _base.HOOKS


def read(trace):
    mine = {_base.__name__: trace.profiled_values.get(__name__)}
    return _base.read(dataclasses.replace(trace, profiled_values=mine))
