"""qp_roofline: the least time the IPM's linear algebra needs, as a share
of all device time inside `_filter_core`'s ranges, over the profiled
calls. The work is every Schur system the calls factor and solve: each
pass factors one n x n system a lane and solves it twice, and the polish
factors K (n) and M (k_sel = min(n + 4, rows)), solves K for k_sel + 1
right-hand sides and both once more in each refinement
(roofline.qp_work). The denominator is the stage's device time whatever
kernels carry it."""

import roofline


def _shape(args, kwargs, out):
    u, slack, sol = out[0], out[1], out[2]
    B, n = u.shape[0], u.shape[1] * u.shape[2]
    m2 = slack.shape[1] * slack.shape[2]
    return B, n, 4 * n + m2, sol.iterations.max()


HOOKS = {"_filter_core": _shape}


def read(trace):
    vals = trace.profiled_values.get(__name__)
    device_s = trace.stage_device_s.get("_filter_core")
    if not vals or not device_s:
        return None
    cap = trace.config["qp_iters"]
    least = sum(roofline.least_seconds(*roofline.qp_work(
        B, n, rows, int(min(k + 1, cap)))) for B, n, rows, k in vals)
    return 100.0 * least / device_s
