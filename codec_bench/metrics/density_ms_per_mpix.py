"""Device milliseconds of the training step's density phase (the density
model's SGD step on the no-grad encoder's latents) per model-megapixel
trained: from each traced step's ``density`` mark to its ``forward``
mark (``codec_bench.phases``), summed, over the traced steps' Mpix."""

from codec_bench.phases import ms_per_mpix


def read(run):
    return ms_per_mpix(run, "density", "forward")
