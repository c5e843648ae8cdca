"""Reading a ``torch.profiler`` trace of part of the measured window.

The interval union and the kernel split are frozen copies of the port's
``eval/ladder_probe.py::busy_us`` and ``kernel_split`` (cuDNN runs a
grouped conv's groups side by side, so the device's busy time is the
union of its operations' intervals, not the sum of their durations).
The benchmark's own spans (``codec_bench.*``) mark the traced window
and, where the benchmark wraps a call into a layer, the host's activity.
"""

import contextlib
import time

import numpy
import torch

SPAN_PREFIX = "codec_bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
CONV_TAGS = ("cudnn", "xmma", "implicit_gemm", "conv", "dgrad", "wgrad", "fprop", "cutlass")
GDN_TAGS = ("gdn_f32_kernel", "gdn_bf16_kernel")


def is_gdn(name):
    return any(tag in name for tag in GDN_TAGS)


def is_conv(name):
    lowered = name.lower()
    return not is_gdn(name) and any(tag in lowered for tag in CONV_TAGS)


def union_s(intervals, window=None):
    """Seconds covered by the union of ``(start, end)`` intervals (us),
    clipped to ``window`` when given."""
    spans = sorted(intervals)
    if window is not None:
        spans = [(max(lo, window[0]), min(hi, window[1])) for (lo, hi) in spans]
        spans = [(lo, hi) for (lo, hi) in spans if hi > lo]
    if not spans:
        return 0.0
    (total, (start, end)) = (0.0, spans[0])
    for (lo, hi) in spans[1:]:
        if lo > end:
            (total, start, end) = (total + end - start, lo, hi)
        else:
            end = max(end, hi)
    return 1e-6 * (total + end - start)


def _events(profiler):
    """``(device, host)`` lists of ``(name, start_us, end_us)``. The
    device's copies of the benchmark's own spans (annotations, not
    operations) are left out."""
    (device, host) = ([], [])
    try:
        raw = profiler.profiler.kineto_results.events()
        for event in raw:
            start = event.start_ns() / 1e3
            entry = (event.name(), start, start + event.duration_ns() / 1e3)
            (device if event.device_type() == torch.autograd.DeviceType.CUDA else host).append(
                entry)
    except AttributeError:
        for event in profiler.events():
            entry = (event.name, event.time_range.start, event.time_range.end)
            if event.device_type == torch.autograd.DeviceType.CUDA:
                device.append(entry)
            else:
                host.append(entry)
    device = [event for event in device if not event[0].startswith(SPAN_PREFIX)]
    return (device, host)


class Trace:
    """The device's operations and the host's activity in the traced
    window (the benchmark's ``codec_bench.window`` span)."""

    def __init__(self, device_events, host_events):
        windows = [(lo, hi) for (name, lo, hi) in host_events if name == WINDOW_SPAN]
        if windows:
            self.window = (min(lo for (lo, _) in windows), max(hi for (_, hi) in windows))
        else:
            stamps = [t for (_, lo, hi) in device_events + host_events for t in (lo, hi)]
            self.window = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
        self.device = [(name, lo, hi) for (name, lo, hi) in device_events
                       if hi > self.window[0] and lo < self.window[1]]
        self.host = host_events
        self._host = None

    @classmethod
    def from_profiler(cls, profiler):
        return cls(*_events(profiler))

    def require(self, labels):
        """Raises unless the host recorded a span of each of ``labels``.
        The benchmark's labels wrap calls of the program by their names
        (:func:`labelled`); one that recorded nothing while requests
        were traced means that the program no longer makes that call so,
        and the idle time would lose its name unseen."""
        recorded = {name for (name, _, _) in self.host}
        missing = [label for label in labels if label not in recorded]
        if missing:
            raise RuntimeError(f"the traced requests recorded no {', '.join(missing)} span: "
                               "the program no longer calls what the label wraps.")

    def window_s(self):
        return 1e-6 * (self.window[1] - self.window[0])

    def union(self, select=None):
        """Seconds of the window in which a selected device operation ran."""
        return union_s([(lo, hi) for (name, lo, hi) in self.device
                        if select is None or select(name)], self.window)

    def busy_s(self):
        return self.union()

    def breakdown(self, top=10, labelled_gaps=500):
        """The device operations that took most time (summed by name) and
        the idle time by what the host was doing then (the longest
        ``labelled_gaps`` gaps labelled one by one, the rest summed)."""
        by_name = {}
        for (name, lo, hi) in self.device:
            by_name[name] = by_name.get(name, 0.0) + 1e-6 * (hi - lo)
        device_ops = sorted(by_name.items(), key=lambda item: -item[1])[:top]
        gaps = sorted(self.gaps(), key=lambda gap: gap[0] - gap[1])
        idle = {}
        for (lo, hi) in gaps[:labelled_gaps]:
            label = self.host_activity(lo, hi)
            idle[label] = idle.get(label, 0.0) + 1e-6 * (hi - lo)
        if len(gaps) > labelled_gaps:
            shortest = gaps[labelled_gaps - 1]
            idle[f"gaps under {shortest[1] - shortest[0]:.1f} us"] = 1e-6 * sum(
                hi - lo for (lo, hi) in gaps[labelled_gaps:])
        idle_gaps = sorted(idle.items(), key=lambda item: -item[1])[:top]
        return {"device_ops": [[name[:120], seconds] for (name, seconds) in device_ops],
                "idle_gaps": [[name[:120], seconds] for (name, seconds) in idle_gaps]}

    def gaps(self):
        """``(start, end)`` of each stretch of the window with nothing on
        the device."""
        spans = sorted((max(lo, self.window[0]), min(hi, self.window[1]))
                       for (_, lo, hi) in self.device)
        (gaps, cursor) = ([], self.window[0])
        for (lo, hi) in spans:
            if lo > cursor:
                gaps.append((cursor, lo))
            cursor = max(cursor, hi)
        if self.window[1] > cursor:
            gaps.append((cursor, self.window[1]))
        return gaps

    def host_activity(self, lo, hi):
        """The innermost host event that covers at least half of ``[lo,
        hi]``, else the one that overlaps it most."""
        if self._host is None:
            kept = [(name, start, end) for (name, start, end) in self.host
                    if name != WINDOW_SPAN]
            self._host = ([name for (name, _, _) in kept],
                          numpy.array([start for (_, start, _) in kept], dtype=numpy.float64),
                          numpy.array([end for (_, _, end) in kept], dtype=numpy.float64))
        (names, starts, ends) = self._host
        if not names:
            return "host, outside any recorded op"
        overlap = numpy.minimum(ends, hi) - numpy.maximum(starts, lo)
        covering = overlap >= 0.5 * (hi - lo)
        if covering.any():
            index = numpy.flatnonzero(covering)[numpy.argmin((ends - starts)[covering])]
        elif overlap.max() > 0:
            index = int(numpy.argmax(overlap))
        else:
            return "host, outside any recorded op"
        return names[index]


@contextlib.contextmanager
def labelled(module, attribute, label):
    """While open, ``module.attribute`` (a function the program calls)
    runs inside a profiler span ``label``: the benchmark's span around a
    call into a layer, so that the trace can say what the host did. It
    stands in until the program records such spans itself; a traced run
    checks with :meth:`Trace.require` that each label recorded one."""
    original = getattr(module, attribute)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return original(*args, **kwargs)

    setattr(module, attribute, wrapped)
    try:
        yield
    finally:
        setattr(module, attribute, original)


def profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def start(profile):
    """Starts the profiler; returns the seconds that took, which the
    window does not count."""
    started = time.perf_counter()
    profile.start()
    return time.perf_counter() - started


def stop(profile):
    """Stops the profiler and reads its trace: ``(Trace, seconds that
    took)``; the window does not count those seconds."""
    started = time.perf_counter()
    profile.stop()
    return (Trace.from_profiler(profile), time.perf_counter() - started)
