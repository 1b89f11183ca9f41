"""halfspace_roofline: the least time the halfspace stage's work needs,
as a share of the stage's device time, over the profiled calls. Bytes:
each sample of the n_steps timesteps the stage reads, once (rows x N x 2
float32), the ego reference once, and the seven float32 of each row's
halfspaces written once (roofline.halfspace_work). The denominator is
all device time in the stage's range, so the row-layout copy counts."""

import roofline

NAME = "compute_safe_halfspaces_for_trajectory"


def _shape(args, kwargs, out):
    samples, x_ref = args[1], args[2]
    return out.mean.g_tilde.numel(), samples.shape[2], x_ref.numel()


HOOKS = {NAME: _shape}


def read(trace):
    vals = trace.profiled_values.get(__name__)
    device_s = trace.stage_device_s.get(NAME)
    if not vals or not device_s:
        return None
    least = sum(roofline.least_seconds(*roofline.halfspace_work(r, n, e))
                for r, n, e in vals)
    return 100.0 * least / device_s
