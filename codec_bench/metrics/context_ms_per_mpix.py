"""Device milliseconds of the joint prior's context model per
model-megapixel trained: from each traced step's ``aeic_mark_context``
kernel to its ``aeic_mark_synthesis`` kernel (the masked conv, the
entropy parameters and the mean-scale likelihood of ``y``), summed over
the whole steps of ``codec_bench.phases.steps``, over the traced steps'
Mpix. The two marks split the program's ``forward`` phase;
``codec_bench.phases`` does not know them, so they are found here by
kernel name, as ``entropy_ms_per_mpix.py`` finds its own. None where the
run has no trace or no such marks (a step without a context model)."""

import bisect
import re

from codec_bench.phases import KERNEL_PREFIX, steps

_MARK = re.compile(re.escape(KERNEL_PREFIX) + r"(context|synthesis)(?![a-z_])")


def read(run):
    if run.trace is None or not run.traced.get("mpix"):
        return None
    marks = sorted((start, found.group(1)) for (name, start, _) in run.trace.device
                   for found in [_MARK.search(name)] if found is not None)
    starts = [start for (start, _) in marks]
    (total, found) = (0.0, False)
    for step in steps(run.trace):
        (lo, hi) = (step[0][1], step[-1][1])
        opened = None
        for (start, mark) in marks[bisect.bisect_left(starts, lo):
                                   bisect.bisect_right(starts, hi)]:
            if mark == "context":
                opened = start
            elif opened is not None:
                (total, found, opened) = (total + start - opened, True, None)
    return 1e-3 * total / run.traced["mpix"] if found else None
