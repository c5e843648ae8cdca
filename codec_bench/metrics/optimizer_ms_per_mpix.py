"""Device milliseconds of the training step's optimizer phase (Adam, the
bin widths, the projections and the write into the graph's static
buffers) per model-megapixel trained: from each traced step's
``optimizer`` mark to its ``step_end`` mark (``codec_bench.phases``),
summed, over the traced steps' Mpix."""

from codec_bench.phases import ms_per_mpix


def read(run):
    return ms_per_mpix(run, "optimizer", "step_end")
