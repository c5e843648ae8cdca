"""Device milliseconds of the training step's rate-distortion forward pass
per model-megapixel trained: from each traced step's ``forward`` mark to
its ``backward`` mark (``codec_bench.phases``), summed, over the traced
steps' Mpix."""

from codec_bench.phases import ms_per_mpix


def read(run):
    return ms_per_mpix(run, "forward", "backward")
