"""The whole request's or training step's share of the card's peak: the
least time the published peaks allow for the model FLOPs of everything
served or trained in the window (each layer at the peak of the dtype the
path computes it in; a step's forward, both gradients and the density
phase's encoder forward), over the window's time."""

from codec_bench.roofline import least_time_s


def read(run):
    if run.window_s <= 0 or not run.work.get("flops"):
        return None
    return 100.0 * least_time_s(run.work["flops"]) / run.window_s
