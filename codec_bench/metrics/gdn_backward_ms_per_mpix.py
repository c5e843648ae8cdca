"""Device milliseconds of the GDN sites' backward (plain PyTorch inside the
backward pass) per model-megapixel trained: from each
``gdn_backward_begin`` mark of a traced step to its ``gdn_backward_end``
mark (``codec_bench.phases``), summed, over the traced steps' Mpix."""

from codec_bench.phases import ms_per_mpix


def read(run):
    return ms_per_mpix(run, "gdn_backward_begin", "gdn_backward_end")
