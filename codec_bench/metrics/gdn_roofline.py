"""The GDN kernels' share of their roofline: the least time of the traced
requests' or steps' GDN / IGDN launches (each site's rows from the
path's shapes, ``codec_bench.roofline.gdn_bound_s`` at the published
peaks; in training the forward launches of the density phase's encoder
and of the autoencoder phase, the backward being plain PyTorch) over
the trace's time in the GDN kernels."""

from codec_bench.trace import is_gdn


def read(run):
    if run.trace is None or not run.traced.get("gdn_bound_s"):
        return None
    seconds = run.trace.union(is_gdn)
    return 100.0 * run.traced["gdn_bound_s"] / seconds if seconds > 0 else None
