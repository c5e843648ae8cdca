"""Device milliseconds of convolution kernels per megapixel served, or
per model-megapixel trained: the union of the conv kernels' intervals in
the trace (cuDNN may overlap them, and runs a grouped conv's groups side
by side) over the megapixels of the traced requests or steps."""

from codec_bench.trace import is_conv


def read(run):
    if run.trace is None or not run.traced.get("mpix"):
        return None
    seconds = run.trace.union(is_conv)
    return 1e3 * seconds / run.traced["mpix"] if seconds > 0 else None
