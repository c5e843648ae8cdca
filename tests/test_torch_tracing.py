"""PyTorch port: the phase marks of a training step and the program's own
spans (``utils/tracing.py``), and the benchmark's readers of the marks
(``codec_bench/phases.py`` and its six per-layer metrics).

On the CPU a step's marks are profiler ranges only: a graphed epoch's
capture also launches them as kernels, which only the card runs (the
``cuda``-marked test). Small sizes: 32 x 32 crops at batch 2,
``max_itvs=32``, a ladder of three gammas. This file imports no JAX, so
that its ``cuda`` test runs where JAX is not installed.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import pickle
import re
from types import SimpleNamespace

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    PipelinedCompressor,
)
from autoencoder_based_image_compression_tpu_torch.train import epoch_graph, loop
from autoencoder_based_image_compression_tpu_torch.train import ladder as tladder
from autoencoder_based_image_compression_tpu_torch.train import step as tstep
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    init_train_state,
    map_state,
    state_leaves,
)
from autoencoder_based_image_compression_tpu_torch.utils import tracing
from codec_bench import harness, phases, trace

GAMMA = 10000.0
GAMMAS = (10000.0, 24000.0, 72000.0)
MAX_ITVS = 32
# GDN sites whose backward runs in a train_step: the learned model's GDN_1,
# GDN_2, IGDN_5 and IGDN_6; the fixed model and the ladder add GDN_3, IGDN_4.
GDN_SITES = {"learned": 4, "fixed": 6, "ladder": 6}
NEW_METRICS = ("density_ms_per_mpix.train", "forward_ms_per_mpix.train",
               "backward_ms_per_mpix.train", "gdn_backward_ms_per_mpix.train",
               "optimizer_ms_per_mpix.train", "step_gap_share.train")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(model, device="cpu"):
    generator = torch.Generator().manual_seed(0)
    if model == "ladder":
        state = tladder.init_ladder_state(generator, GAMMAS, max_itvs=MAX_ITVS, device="cpu")
        fns = tladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS)
    else:
        learn_bin_widths = model == "learned"
        state = init_train_state(generator, 1.0, learn_bin_widths, max_itvs=MAX_ITVS,
                                 device="cpu")
        fns = tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    return (map_state(lambda leaf: leaf.to(device), state), fns)


def _data(nb_batches, device="cpu", seed=1):
    rng = numpy.random.default_rng(seed)
    nb_images = 2 * nb_batches
    dataset = torch.from_numpy(rng.integers(0, 256, size=(nb_images, 32, 32, 1)).astype(
        numpy.uint8)).to(device)
    return (dataset, torch.as_tensor(rng.permutation(nb_images).reshape(nb_batches, 2)))


def _host_ranges(profile, names, args=False):
    """``(name, start, end)`` of the profiler's ranges named in ``names``,
    in order of start (an enclosing range before what it encloses), with
    ``args`` each range's keyword inputs last. Each is a host range: no
    user annotation, which a device trace would copy onto the card's
    timeline."""
    events = [event for event in profile.events() if event.name in names]
    assert not any(event.is_user_annotation for event in events)
    ranges = [(event.name, event.time_range.start, event.time_range.end)
              + ((event.kwinputs,) if args else ()) for event in events]
    return sorted(ranges, key=lambda event: (event[1], -event[2]))


def _profiled_step(fn_name, model):
    (state, fns) = _model(model)
    (dataset, rows) = _data(1)
    program = epoch_graph.EpochProgram(fns[fn_name], state, dataset, rows,
                                       torch.Generator().manual_seed(5))
    program.load(state, dataset, rows, None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        program.step(program.buffers, program.counter)
    return _host_ranges(profile, set(tracing.MARKS))


@pytest.mark.parametrize("model", ["learned", "fixed", "ladder"])
def test_a_train_step_records_its_phases_in_order(model):
    ranges = _profiled_step("train_step", model)
    pairs = list(tracing.GDN_BACKWARD) * GDN_SITES[model]
    assert [name for (name, _, _) in ranges] == (
        ["step", "density", "forward", "backward"] + pairs + ["optimizer", "step_end"])
    (_, start, end) = ranges[3]
    assert all(start <= lo and hi <= end for (_, lo, hi) in ranges[4:4 + len(pairs)])


@pytest.mark.parametrize("model", ["learned", "ladder"])
def test_a_pre_fit_step_records_step_density_step_end(model):
    assert [name for (name, _, _) in _profiled_step("training_fct", model)] == [
        "step", "density", "step_end"]


def test_a_mark_outside_a_capture_launches_nothing_and_unknown_marks_are_refused():
    recorder = tracing.Recorder()
    with tracing.recording(recorder):
        tracing.mark("step")
        with tracing.phase("density"):
            pass
        with pytest.raises(ValueError, match="not a mark"):
            tracing.mark("epoch.load")
    assert recorder.names == ["step", "density"] and recorder.launched == 0
    tracing.mark("step")  # no recorder: a profiler range only
    assert recorder.names == ["step", "density"]


def test_stamps_give_each_phase_its_median_ms():
    marks = ("step", "density", "forward", "backward", "gdn_backward_begin",
             "gdn_backward_end", "gdn_backward_begin", "gdn_backward_end", "optimizer",
             "step_end")
    offsets_us = numpy.array([0, 10, 1010, 3010, 3100, 3300, 3400, 3500, 7010, 7510])
    stamps = 1000 * numpy.stack([offsets_us + 10000 * i for i in range(3)])
    stamps[1] += 1000 * numpy.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 500])  # a slow optimizer
    got = epoch_graph.phase_ms(marks, stamps)
    assert got == pytest.approx({"gather": 0.01, "density": 1.0, "forward": 2.0,
                                 "backward": 4.0, "gdn_backward": 0.3, "optimizer": 0.5,
                                 "step": 7.51})
    assert list(epoch_graph.phase_ms(("step", "density", "step_end"), stamps[:, [0, 1, 9]])) == [
        "gather", "density", "step"]


def test_the_operators_line_reads_the_phases():
    phases_ms = {"gather": 0.012, "density": 1.5, "forward": 3.0, "backward": 5.25,
                 "gdn_backward": 0.75, "optimizer": 0.4, "step": 10.162}
    line = loop.phase_line(SimpleNamespace(phase_ms=lambda: phases_ms))
    assert line == ("Device ms a step by phase: gather 0.012, density 1.500, forward 3.000, "
                    "backward 5.250 (GDN backward 0.750), optimizer 0.400; step 10.162")
    assert loop.phase_line(SimpleNamespace(phase_ms=lambda: None)) is None
    (_, fns) = _model("learned")
    assert fns["train_epoch"].phase_ms() is None  # no graphed epoch ran
    (_, fns) = _model("ladder")
    assert fns["train_epoch"].phase_ms() is None and fns["fit_epoch"].phase_ms() is None


def test_an_epochs_replay_and_collect_spans():
    (state, fns) = _model("fixed")
    (dataset, rows) = _data(2)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows,
                                       torch.Generator().manual_seed(5))
    program.load(state, dataset, rows, None)
    epoch = object.__new__(epoch_graph._CapturedEpoch)
    epoch.program = program
    epoch.graph = SimpleNamespace(replay=lambda: program.step(program.buffers, program.counter))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as profile:
        out = epoch.run({"epoch": 7})
    ranges = _host_ranges(profile, {"epoch.replay", "epoch.collect", "step", "step_end"},
                          args=True)
    assert [name for (name, _, _, _) in ranges] == (
        ["epoch.replay"] + ["step", "step_end"] * 2 + ["epoch.collect"])
    assert ranges[0][3] == ranges[-1][3] == {"epoch": 7}
    assert int(out.step) == 2


# --- the benchmark's readers -------------------------------------------------

def _kernel(name, start, end):
    return (name, float(start), float(end))


def _mark(mark, start):
    return (f"{phases.KERNEL_PREFIX}{mark}", float(start), float(start) + 1.0)


def _step(t0, gap=False):
    """One step's marks at ``t0`` (us): gather 10, density 40, forward 50,
    backward 100 with two GDN backwards of 10 and 15, optimizer 20; work
    covers the whole step but, with ``gap``, 5 us after the forward."""
    marks = [("step", 0), ("density", 10), ("forward", 50), ("backward", 100),
             ("gdn_backward_begin", 120), ("gdn_backward_end", 130),
             ("gdn_backward_begin", 150), ("gdn_backward_end", 165),
             ("optimizer", 200), ("step_end", 220)]
    work = ([_kernel("sm80_xmma_fprop", t0, t0 + 100), _kernel("elementwise_kernel",
                                                               t0 + 105, t0 + 225)]
            if gap else [_kernel("sm80_xmma_fprop", t0, t0 + 225)])
    return [_mark(mark, t0 + at) for (mark, at) in marks] + work


def _run(device, window=(0.0, 1000.0), mpix=2.0):
    host = [(trace.WINDOW_SPAN, *window)]
    return harness.Run(trace=trace.Trace(device, host), traced={"mpix": mpix})


def _read(run):
    registry = harness.Registry()
    return {name: registry.reader(name).read(run) for name in NEW_METRICS}


@pytest.mark.parametrize("case", ["tiling", "gap", "cut by the window"])
def test_readers_of_marked_steps(case):
    """Two whole steps at 100 and 400 us in a window of 0 to 1000 us;
    ``gap`` leaves 5 us of the second without work; steps cut by the
    window (begun before it, or ended after it) are left out."""
    device = _step(100.0) + _step(400.0, gap=case == "gap")
    if case == "cut by the window":
        device += _step(-150.0) + _step(900.0)
    got = _read(_run(device))
    per_mpix = 1e-3 / 2.0  # two steps' us -> ms, over 2 Mpix
    assert got["density_ms_per_mpix.train"] == pytest.approx(2 * 40 * per_mpix)
    assert got["forward_ms_per_mpix.train"] == pytest.approx(2 * 50 * per_mpix)
    assert got["backward_ms_per_mpix.train"] == pytest.approx(2 * 100 * per_mpix)
    assert got["gdn_backward_ms_per_mpix.train"] == pytest.approx(2 * 25 * per_mpix)
    assert got["optimizer_ms_per_mpix.train"] == pytest.approx(2 * 20 * per_mpix)
    gap_us = 5.0 if case == "gap" else 0.0
    assert got["step_gap_share.train"] == pytest.approx(100.0 * gap_us / 440.0)
    assert len(phases.steps(_run(device).trace)) == 2
    # Gather, density, forward, backward and optimizer tile each step.
    gather = phases.seconds_between(_run(device).trace, "step", "density")
    tiled = gather + sum(1e-3 * got[name] * 2.0 for name in NEW_METRICS[:3] + NEW_METRICS[4:5])
    assert tiled == pytest.approx(2 * 220e-6)


def test_readers_find_nothing_without_a_trace_or_marks():
    assert all(value is None for value in _read(harness.Run()).values())
    unmarked = _run([_kernel("sm80_xmma_fprop", 0.0, 100.0)])
    assert all(value is None for value in _read(unmarked).values())


def test_mark_names_are_declared_and_match_no_benchmark_tag():
    # The benchmark's phases know the marks that tile a step and the GDN
    # backward's; the forward's own marks come after them and are found by
    # their kernel names (codec_bench/metrics/entropy_ms_per_mpix.py).
    assert tracing.MARKS == phases.MARKS + tracing.FORWARD_MARKS
    with open(os.path.join(REPO, "autoencoder_based_image_compression_tpu_torch", "csrc",
                           "gdn.cu")) as file:
        source = file.read()
    declared = set(re.findall(r"AEIC_MARK_KERNEL\((aeic_mark_[a-z_]+)\)", source))
    names = {phases.KERNEL_PREFIX + mark for mark in tracing.MARKS}
    assert declared == names
    for name in names:
        assert f'{{"{name}", {name}}}' in source
        assert not trace.is_conv(name) and not trace.is_gdn(name)
        mark = name[len(phases.KERNEL_PREFIX):]
        if mark in phases.MARKS:
            assert phases.mark_of(name) == mark
            assert phases.mark_of(f"void {name}(long long*, long long const*)") is not None
        else:
            assert phases.mark_of(name) is None


# --- the serving pipeline's spans ----------------------------------------------

def test_pipeline_spans_nest_around_its_timing():
    exp_dir = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
    (params, bin_widths) = load_params_artifact(os.path.join(exp_dir, "params_trained.npz"))
    stats = os.path.join(exp_dir, "statistics")
    with open(os.path.join(stats, "idx_map_exception.pkl"), "rb") as file:
        idx_exc = pickle.load(file)
    compressor = PipelinedCompressor(
        params_from_jax(params), numpy.asarray(bin_widths), True,
        numpy.load(os.path.join(stats, "binary_probabilities_1.npy")),
        numpy.load(os.path.join(stats, "map_mean.npy")), idx_map_exception=idx_exc,
        batch_size=2, max_in_flight=2, device="cpu")
    images = synthetic_luminance_stack(4, 32, 48, seed=7)
    compressor(images)
    names = {"pipeline.request", "pipeline.dispatch", "pipeline.fetch_wait", "pipeline.coder"}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as profile:
        compressor(images)
    with_args = _host_ranges(profile, names, args=True)
    assert {(name, tuple(sorted(args.items()))) for (name, _, _, args) in with_args} == (
        {("pipeline.request", (("request", 2),))}
        | {(name, (("request", 2), ("unit", unit))) for unit in (0, 1)
           for name in ("pipeline.dispatch", "pipeline.fetch_wait", "pipeline.coder")})
    ranges = _host_ranges(profile, names)
    assert [name for (name, _, _) in ranges].count("pipeline.request") == 1
    (_, start, end) = ranges[0]
    assert ranges[0][0] == "pipeline.request"
    assert all(start <= lo and hi <= end for (_, lo, hi) in ranges[1:])
    counts = {name: [n for (n, _, _) in ranges].count(name) for name in names}
    # Two units: two dispatches, two codings, two waits for symbols and two
    # for reconstructions.
    assert counts == {"pipeline.request": 1, "pipeline.dispatch": 2, "pipeline.coder": 2,
                      "pipeline.fetch_wait": 4}
    assert compressor.requests == 2 and set(compressor.last_timing) == {
        "wall", "coder", "fetch_wait"}


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_graphed_epoch_stamps_agree_with_the_trace_and_keep_the_state():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured and replayed on the card")
    cuda_device = "cuda"
    (state, fns) = _model("learned", cuda_device)
    (dataset, rows) = _data(4, cuda_device)
    generator = torch.Generator(cuda_device).manual_seed(3)
    epoch = fns["train_epoch"]
    state = epoch(state, dataset, rows, generator)  # captures
    capture = epoch_graph.CAPTURES[-1]
    slots = 6 + 2 * GDN_SITES["learned"]
    assert len(capture["marks"]) == slots and capture["marks"][0] == "step"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as profile:
        epoch(state, dataset, rows, generator)
        torch.cuda.synchronize()
    stamps = epoch.phase_ms.__self__.last.program.stamps.cpu().numpy()
    assert stamps.shape == (4, slots)
    assert numpy.all(numpy.diff(stamps.reshape(-1)) > 0)
    from_stamps = epoch.phase_ms()
    traced = trace.Trace.from_profiler(profile)
    steps = phases.steps(traced)
    assert len(steps) == 4 and [mark for (mark, _) in steps[0]] == list(capture["marks"])
    starts_ns = numpy.array([[1e3 * start for (_, start) in step] for step in steps])
    from_trace = epoch_graph.phase_ms(capture["marks"], starts_ns)
    print("phase ms from the stamps", from_stamps, "from the trace", from_trace)
    assert set(from_stamps) == set(from_trace)
    for name in from_stamps:
        assert from_stamps[name] == pytest.approx(from_trace[name], rel=0.05), name
    host = {name for (name, _, _) in traced.host}
    assert {"epoch.load", "epoch.replay", "epoch.collect"} <= host

    # The marks write only the stamps: one graphed step against one eager
    # step with the same noise, within 1e-4 of each leaf's largest entry
    # (the bound of tests/test_torch_epoch_graph.py).
    (state, _) = _model("learned", cuda_device)
    noise = [tuple(torch.rand((2, 2, 2, 128), generator=torch.Generator().manual_seed(i))
                   .to(cuda_device) - 0.5 for i in range(2))]
    got = epoch(state, dataset, rows[:1], noise)
    expected = epoch_graph.epoch_over_rows(fns["train_step"], state, dataset, rows[:1], noise)
    for (a, b) in zip(state_leaves(got), state_leaves(expected), strict=True):
        (a, b) = (a.double(), b.double())
        assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max()) + 1e-6)
    assert gdn_kernel.load_library().marks == {
        phases.KERNEL_PREFIX + mark: i for (i, mark) in enumerate(tracing.MARKS)}
