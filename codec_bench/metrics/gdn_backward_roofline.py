"""The GDN gradient kernel's share of its roofline: the least time of the
traced steps' GDN gradients (each site's tile pass and reduction, its
rows from the path's shapes; ``traced["gdn_backward_bound_s"]``, which a
driver gives where it counts them, as ``roofline_minnen2018.py`` does at
192 channels) over the trace's time in the gradient kernel's two
kernels, ``gdn_bwd_f32_kernel`` and ``gdn_bwd_reduce_kernel`` (the union
of their intervals). None where the run has no trace, no such bound or
no such kernel."""

_TAGS = ("gdn_bwd_f32_kernel", "gdn_bwd_reduce_kernel")


def is_gdn_backward(name):
    return any(tag in name for tag in _TAGS)


def read(run):
    if run.trace is None or not run.traced.get("gdn_backward_bound_s"):
        return None
    seconds = run.trace.union(is_gdn_backward)
    return 100.0 * run.traced["gdn_backward_bound_s"] / seconds if seconds > 0 else None
