"""Device milliseconds of the training step's backward pass per
model-megapixel trained, its GDN backward included: from each traced
step's ``backward`` mark to its ``optimizer`` mark
(``codec_bench.phases``), summed, over the traced steps' Mpix."""

from codec_bench.phases import ms_per_mpix


def read(run):
    return ms_per_mpix(run, "backward", "optimizer")
