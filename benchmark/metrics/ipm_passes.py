"""ipm_passes: the passes the IPM's host loop makes a call, averaged over
the traced window's calls of `_filter_core`. A lane that stops after k
iterations took k + 1 passes (the last one finds it converged), and no
lane runs past `qp_iters`, so a call makes min(max_k + 1, qp_iters)
passes, with max_k the largest of its lanes' `iterations`."""

HOOKS = {"_filter_core": lambda args, kwargs, out: out[2].iterations.max()}


def read(trace):
    vals = trace.values.get(__name__)
    if not vals:
        return None
    cap = trace.config["qp_iters"]
    return sum(min(v + 1, cap) for v in vals) / len(vals)
