"""The program's phase marks in a device trace: each replayed training
step cut into its phases.

The program marks every phase of a graphed training step with a
one-thread kernel of its own name, ``aeic_mark_<mark>``, which every
replay runs. The marks ``step``, ``density``, ``forward``, ``backward``,
``optimizer`` and ``step_end`` tile a step, and inside ``backward`` each
GDN site's backward lies between ``gdn_backward_begin`` and
``gdn_backward_end``. This reads them by kernel name alone. A step
counts only if both its ``step`` and its ``step_end`` marks start inside
the traced window; the device time from mark A to mark B is the start of
A to the start of B.
"""

import bisect
import re

KERNEL_PREFIX = "aeic_mark_"
MARKS = ("step", "density", "forward", "backward", "optimizer", "step_end",
         "gdn_backward_begin", "gdn_backward_end")
_MARK = re.compile(re.escape(KERNEL_PREFIX) + r"([a-z_]+)")


def mark_of(name):
    """The mark a device operation's name is, or None."""
    found = _MARK.search(name)
    return found.group(1) if found and found.group(1) in MARKS else None


def steps(trace):
    """The window's whole steps, in order: each a list of ``(mark,
    start_us)`` from its ``step`` to its ``step_end``."""
    (lo, hi) = trace.window
    marks = sorted((start, mark) for (name, start, _) in trace.device
                   for mark in [mark_of(name)] if mark is not None and lo <= start <= hi)
    (whole, current) = ([], None)
    for (start, mark) in marks:
        if mark == "step":
            current = [(mark, start)]
        elif current is not None:
            current.append((mark, start))
            if mark == "step_end":
                whole.append(current)
                current = None
    return whole


def seconds_between(trace, first, then):
    """Device seconds from each ``first`` mark to the next ``then`` mark
    of the same step, summed over the window's whole steps, or None
    where no step has both."""
    (total, found) = (0.0, False)
    for step in steps(trace):
        opened = None
        for (mark, start) in step:
            if mark == first:
                opened = start
            elif mark == then and opened is not None:
                (total, found, opened) = (total + start - opened, True, None)
    return 1e-6 * total if found else None


def _merged(intervals):
    """The union of ``(start, end)`` intervals as sorted, disjoint
    ``(starts, ends)``."""
    (starts, ends) = ([], [])
    for (lo, hi) in sorted(intervals):
        if ends and lo <= ends[-1]:
            ends[-1] = max(ends[-1], hi)
        else:
            starts.append(lo)
            ends.append(hi)
    return (starts, ends)


def gap_seconds(trace):
    """``(gaps, walls)``: over the window's whole steps, the device
    seconds from ``step`` to ``step_end`` in which no operation but a mark
    ran, and those steps' device wall seconds."""
    (starts, ends) = _merged([(lo, hi) for (name, lo, hi) in trace.device
                              if mark_of(name) is None])
    (gaps, walls) = (0.0, 0.0)
    for step in steps(trace):
        (lo, hi) = (step[0][1], step[-1][1])
        (busy, i) = (0.0, bisect.bisect_right(ends, lo))
        while i < len(starts) and starts[i] < hi:
            busy += min(ends[i], hi) - max(starts[i], lo)
            i += 1
        walls += 1e-6 * (hi - lo)
        gaps += 1e-6 * (hi - lo - busy)
    return (gaps, walls)


def ms_per_mpix(run, first, then):
    """Device milliseconds from mark ``first`` to mark ``then``, summed
    over the traced steps, per traced model-megapixel; None without a
    trace or marks."""
    if run.trace is None or not run.traced.get("mpix"):
        return None
    seconds = seconds_between(run.trace, first, then)
    return None if seconds is None else 1e3 * seconds / run.traced["mpix"]
