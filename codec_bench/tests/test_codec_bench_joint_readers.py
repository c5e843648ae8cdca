"""The joint-prior cell's two readers on made-up traces:
``context_ms_per_mpix`` (from each step's ``aeic_mark_context`` to its
``aeic_mark_synthesis``) and ``gdn_backward_roofline`` (the gradient's
least time over the union of its two kernels' intervals)."""

import pytest

from codec_bench import harness, trace

WINDOW = [("codec_bench.window", 0.0, 3000.0)]


def _kernel(name, start, end):
    return (name, float(start), float(end))


def _steps(nb, context_us=None, synthesis_us=140, backward=()):
    """Device events of ``nb`` steps of 1000 us: the marks (``context``
    where ``context_us`` is given), a conv, and the ``backward`` kernels
    as ``(name, start, end)`` offsets."""
    events = []
    for i in range(nb):
        t = 1000.0 * i
        marks = [("step", 0), ("forward", 10), ("entropy", 60), ("synthesis", 10 + synthesis_us),
                 ("backward", 500), ("optimizer", 900), ("step_end", 990)]
        if context_us is not None:
            marks.append(("context", 10 + context_us))
        for (mark, offset) in marks:
            events.append(_kernel(f"aeic_mark_{mark}", t + offset, t + offset + 1))
        events.append(_kernel("sm90_xmma_fprop_implicit_gemm", t + 20, t + 480))
        events += [_kernel(name, t + lo, t + hi) for (name, lo, hi) in backward]
    return events


def test_the_context_reader_on_a_small_synthetic_trace():
    reader = harness.Registry().reader("context_ms_per_mpix.train")
    run = harness.Run(trace=trace.Trace(_steps(3, 100, 140), WINDOW), traced={"mpix": 2.0})
    assert reader.read(run) == pytest.approx(1e-3 * 3 * 40 / 2.0)
    # A step cut by the window's end counts nothing.
    cut = trace.Trace(_steps(3, 100, 140), [("codec_bench.window", 0.0, 2500.0)])
    assert reader.read(harness.Run(trace=cut, traced={"mpix": 2.0})) == pytest.approx(
        1e-3 * 2 * 40 / 2.0)
    # A step without a context model (the hyperprior's) reads None; so does
    # a run without a trace.
    hyperprior = harness.Run(trace=trace.Trace(_steps(2), WINDOW), traced={"mpix": 2.0})
    assert reader.read(hyperprior) is None
    assert reader.read(harness.Run()) is None
    # The entropy reader spans both of the forward's entropy phases.
    entropy = harness.Registry().reader("entropy_ms_per_mpix.train")
    assert entropy.read(run) == pytest.approx(1e-3 * 3 * 90 / 2.0)


def test_the_gdn_backward_roofline_on_a_small_synthetic_trace():
    reader = harness.Registry().reader("gdn_backward_roofline.train")
    backward = [("void (anonymous namespace)::gdn_bwd_f32_kernel<192, 1, false>(float)",
                 600, 700),
                ("void (anonymous namespace)::gdn_bwd_reduce_kernel<192>(float)", 700, 710),
                ("void (anonymous namespace)::gdn_bwd_f32_kernel<192, 1, true>(float)", 705, 800),
                ("void (anonymous namespace)::gdn_f32_kernel<192, 3, false, false, false>()",
                 800, 850)]
    events = _steps(2, 100, 140, backward)
    run = harness.Run(trace=trace.Trace(events, WINDOW),
                      traced={"mpix": 1.0, "gdn_backward_bound_s": 2 * 100e-6})
    # Two steps of 200 us in the two kernels (their union), 100 us of bound.
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(harness.Run(trace=trace.Trace(events, WINDOW), traced={})) is None
    without = harness.Run(trace=trace.Trace(_steps(2, 100), WINDOW),
                          traced={"gdn_backward_bound_s": 1e-4})
    assert reader.read(without) is None
    assert reader.read(harness.Run()) is None
