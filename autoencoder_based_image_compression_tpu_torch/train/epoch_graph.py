"""The training epoch as replays of one captured CUDA graph.

Counterpart of the JAX package's scanned epoch (``train/step.py:206-232``
and the ladder's ``train/ladder.py:125-141``): there the whole shuffled
epoch is one ``lax.scan`` that gathers each batch from the
device-resident uint8 dataset inside its body. Here one training step is
captured once into a ``torch.cuda.CUDAGraph`` over static inputs, and an
epoch is ``nb_batches`` replays of it with no host work between them.

Any step of the form ``step(state, batch, noise) -> state`` is taken,
over any state of the port (``train.state.map_state``'s structures): the
Kodak ``train_step`` and its density pre-fit ``training_fct``, one model
or the stacked ladder; the SVHN alternation and pre-fit
(``models/dense_eae.py``); the VAE step; the entropy study's density
fit. Each is the counterpart of a step the JAX package runs as one
jitted program a call. :func:`epoch_fn` gives a step's epoch: the graph
on the card, the eager loop :func:`epoch_over_rows` on the CPU.

**Static inputs** (:class:`EpochProgram`): the state's buffers, the
dataset, the ``(nb_batches, batch_size)`` int64 rows, a device step
counter and the noise: a CUDA ``torch.Generator``, registered with the
graph so that every replay draws on from where the generator stands,
one ``train_step`` noise per batch, stacked in device buffers, or
``None`` for a step that draws nothing. The
captured step gathers ``dataset.index_select(0,
rows.index_select(0, counter))``, runs the unchanged ``train_step`` on
the buffers, writes the new state into them with ``copy_`` and advances
the counter. Everything that needs the host (converting the rows,
checking the noise) happens before the first replay.

**Per epoch** the state, the dataset and the rows go in with one device
copy each (the noise too, when it is given per batch; the dataset only
when it is not the tensor loaded last, unchanged since), the graph
replays once a batch, and the state comes out as a clone: the next epoch
overwrites the buffers, and a caller that keeps an earlier state (a
checkpoint written after the epoch, the stability study) must not see it
change. One step a graph, not K: a replay costs the host a few
microseconds against a step of milliseconds on the card, so the host
stays ahead of the device with one.

**Capture** comes after one eager step on a side stream over a scratch
copy of the state with a scratch generator (cuDNN's plans, the kernels'
library and autograd's threads are set up at a first use, which a
capture refuses), so the first graphed epoch is not a step ahead of the
eager loop. cuDNN's algorithms are chosen then and frozen in the graph:
a capture while ``torch.backends.cudnn.deterministic`` is set raises, so
that no graph keeps the slow deterministic algorithms. A capture or a
replay that fails raises; nothing falls back to the eager loop.

The GDN wrappers count their launches where Python calls them: at the
warm-up step and the capture, never at a replay.

**Phase marks** (``utils/tracing.py``): the warm-up step lists the marks
the step makes; the program then holds a ``(nb_batches, slots)`` int64
device buffer of stamps, and the capture launches one mark kernel a
mark, which every replay runs: each writes the card's global timer at
(the step counter, its slot). :meth:`GraphedEpoch.phase_ms` reads the
last epoch's stamps back, one device-to-host copy made only when asked,
as the median device milliseconds a step of each phase. On the host, an
epoch's spans ``epoch.load`` (the state, dataset, rows and counter into
the buffers), ``epoch.replay`` (the replays) and ``epoch.collect`` (the
state cloned out) carry the epoch's index in their ``args``.
"""

import time
import weakref

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.train.state import (
    clone_state,
    copy_state_into,
    state_leaves,
)
from autoencoder_based_image_compression_tpu_torch.utils import tracing
from autoencoder_based_image_compression_tpu_torch.utils.tracing import mark, phase

# Every capture of this process, in order: what it cost and holds.
CAPTURES = []


def check_noises(noise, nb_batches):
    """Raises unless ``noise`` is a generator, ``None`` or one noise per
    batch."""
    if noise is not None and not isinstance(noise, torch.Generator) and (
            len(noise) != nb_batches):
        raise ValueError(f"{len(noise)} noises for {nb_batches} batches.")


def rows_in_order(nb_batches, batch_size):
    """The ``(nb_batches, batch_size)`` rows of the batches in the
    dataset's order, ``[j * batch_size, (j + 1) * batch_size)`` for batch
    ``j`` (a pre-fit's batches, which slices took before)."""
    return torch.arange(nb_batches * batch_size, dtype=torch.int64).reshape(nb_batches,
                                                                             batch_size)


def epoch_over_rows(step, state, dataset, rows, noise):
    """``step`` over the ``(nb_batches, batch_size)`` row indices of a
    device-resident dataset, each batch gathered on the device; ``noise``
    is a generator, ``None`` or one ``step`` noise per batch. The eager
    loop: an epoch takes it for a state on the CPU."""
    rows = torch.as_tensor(rows, device=dataset.device).to(torch.int64)
    check_noises(noise, rows.shape[0])
    per_batch = noise is not None and not isinstance(noise, torch.Generator)
    for (i, batch_rows) in enumerate(rows):
        state = step(state, dataset.index_select(0, batch_rows), noise[i] if per_batch else noise)
    return state


def phase_ms(marks, stamps):
    """The median over the steps of each phase's milliseconds, from
    ``stamps`` (ns, a step a row, a column a mark of ``marks``, in
    order): ``gather`` (``step`` to the next tiling mark), then each
    tiling mark to the next (``tracing.STEP_MARKS``), ``gdn_backward``
    (each ``gdn_backward_begin`` to its ``gdn_backward_end``, summed) and
    ``step`` (``step`` to ``step_end``); where the step splits its
    forward (``tracing.FORWARD_MARKS``), each of those marks but the last
    it gives too, to the next it gives (``entropy`` to ``synthesis``, or
    to ``context`` and ``context`` to ``synthesis``)."""
    stamps = numpy.asarray(stamps, dtype=numpy.int64)
    tiling = [i for (i, name) in enumerate(marks) if name in tracing.STEP_MARKS]
    spans = {}
    for (a, b) in zip(tiling, tiling[1:]):
        spans["gather" if marks[a] == "step" else marks[a]] = stamps[:, b] - stamps[:, a]
    (begin, end) = tracing.GDN_BACKWARD
    begins = [i for (i, name) in enumerate(marks) if name == begin]
    ends = [i for (i, name) in enumerate(marks) if name == end]
    if begins:
        spans["gdn_backward"] = sum(stamps[:, j] - stamps[:, i]
                                    for (i, j) in zip(begins, ends, strict=True))
    splits = [marks.index(name) for name in tracing.FORWARD_MARKS if name in marks]
    for (a, b) in zip(splits, splits[1:]):
        spans[marks[a]] = stamps[:, b] - stamps[:, a]
    spans["step"] = stamps[:, tiling[-1]] - stamps[:, tiling[0]]
    return {name: float(numpy.median(ns)) / 1e6 for (name, ns) in spans.items()}


def _noise_leaves(noise):
    """The tensors of one ``train_step`` noise (a tensor, or tuples and
    lists of them), in order."""
    if torch.is_tensor(noise):
        return [noise]
    return [leaf for part in noise for leaf in _noise_leaves(part)]


def _noise_like(template, leaves):
    """The structure of ``template`` with its tensors taken in order from
    the iterator ``leaves``."""
    if torch.is_tensor(template):
        return next(leaves)
    return type(template)(_noise_like(part, leaves) for part in template)


def _signature(tree):
    """Shapes, dtypes and nesting of a tensor or of tuples and lists of them."""
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device)
    return (type(tree).__name__, tuple(_signature(part) for part in tree))


class EpochProgram:
    """The static inputs of an epoch over ``rows`` and the step over them.

    :meth:`step` is the body the graph captures; it runs eagerly on any
    device (what the CPU tests hold against ``train.step.epoch_over_rows``).
    ``marks`` and ``stamps`` are set at the capture (module docstring).
    """

    def __init__(self, train_step, state, dataset, rows, noise):
        self.train_step = train_step
        device = dataset.device
        self.buffers = clone_state(state)
        self.dataset = torch.empty_like(dataset)
        # The dataset loaded last (a weak reference) and its version: an
        # epoch over the same tensor, unchanged since, skips its copy.
        self.loaded = (lambda: None, None)
        self.rows = torch.empty(tuple(rows.shape), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        if noise is None or isinstance(noise, torch.Generator):
            (self.generator, self.template, self.noise) = (noise, None, [])
        else:
            (self.generator, self.template) = (None, noise[0])
            self.noise = [torch.empty((len(noise), *leaf.shape), dtype=leaf.dtype,
                                      device=device) for leaf in _noise_leaves(noise[0])]
        (self.marks, self.stamps) = ((), None)

    @property
    def nb_batches(self):
        return self.rows.shape[0]

    def load(self, state, dataset, rows, noise):
        """An epoch's inputs into the static buffers, the counter to 0."""
        copy_state_into(self.buffers, state)
        (loaded, version) = self.loaded
        if loaded() is not dataset or version != dataset._version:
            self.dataset.copy_(dataset)
            self.loaded = (weakref.ref(dataset), dataset._version)
        self.rows.copy_(rows)
        self.counter.zero_()
        if self.template is not None:
            (targets, sources) = ([], [])
            for (i, batch_noise) in enumerate(noise):
                for (buffer, leaf) in zip(self.noise, _noise_leaves(batch_noise)):
                    targets.append(buffer[i])
                    sources.append(leaf)
            torch._foreach_copy_(targets, sources)

    def step(self, buffers, counter, generator=None):
        """One training step on batch ``counter`` of the rows: the new
        state is written into ``buffers``, and ``counter`` advances. Marks
        ``step`` first and ``step_end`` last."""
        with phase("step"):
            batch = self.dataset.index_select(0, self.rows.index_select(0, counter).reshape(-1))
            if self.template is None:
                noise = self.generator if generator is None else generator
            else:
                noise = _noise_like(self.template,
                                    iter([buffer.index_select(0, counter)[0]
                                          for buffer in self.noise]))
        copy_state_into(buffers, self.train_step(buffers, batch, noise))
        mark("step_end")
        counter.add_(1)


class _CapturedEpoch:
    """An :class:`EpochProgram` with its step captured in a CUDA graph."""

    def __init__(self, program):
        if torch.backends.cudnn.deterministic:
            raise RuntimeError(
                "a graphed epoch would capture its step with "
                "torch.backends.cudnn.deterministic set, which freezes cuDNN's slow "
                "deterministic algorithms into every replay; close "
                "utils.device.deterministic_cudnn() first.")
        self.program = program
        device = program.dataset.device
        t0 = time.perf_counter()
        # The warm-up step, on a side stream, over scratch copies: the
        # buffers, the counter and the caller's generator stay as loaded.
        scratch = clone_state(program.buffers)
        counter = torch.zeros_like(program.counter)
        generator = (None if program.generator is None
                     else torch.Generator(device=device).manual_seed(0))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        recorder = tracing.Recorder()
        with torch.cuda.stream(side), tracing.recording(recorder):
            program.step(scratch, counter, generator)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        del scratch, counter, generator
        warmup_s = time.perf_counter() - t0
        # The stamps, a slot a mark the warm-up step made.
        program.marks = tuple(recorder.names)
        program.stamps = torch.zeros((program.nb_batches, len(program.marks)),
                                     dtype=torch.int64, device=device)
        (recorder.stamps, recorder.counter) = (program.stamps, program.counter)
        self.graph = torch.cuda.CUDAGraph()
        if program.generator is not None:
            self.graph.register_generator_state(program.generator)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph), tracing.recording(recorder):
            program.step(program.buffers, program.counter)
        torch.cuda.synchronize(device)
        if recorder.launched != len(program.marks):
            raise RuntimeError(f"the capture launched {recorder.launched} marks where the "
                               f"warm-up step made {len(program.marks)}.")
        CAPTURES.append({"warmup_s": warmup_s, "capture_s": time.perf_counter() - t0,
                         "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
                         "nb_batches": program.nb_batches,
                         "batch_size": program.rows.shape[1],
                         "noise": ("per batch" if program.template is not None
                                   else "generator" if program.generator is not None
                                   else "none"),
                         "marks": program.marks})

    def run(self, args=None):
        with phase("epoch.replay", args):
            for _ in range(self.program.nb_batches):
                self.graph.replay()
        with phase("epoch.collect", args):
            return clone_state(self.program.buffers)


class GraphedEpoch:
    """``train_epoch(state, dataset, rows, noise)`` of one ``train_step``
    on the card, as replays of a captured graph.

    Captures are kept by (dataset shape, the rows' shape, the state's
    shapes and dtypes, the noise form: which generator, none, or the
    shapes of a batch's noise), and live as long as this object, which
    the function of :func:`epoch_fn` holds. The batches are whole: the
    rows are ``(nb_batches, batch_size)`` (a set that batches do not
    divide leaves its remainder out of the rows, as the command lines do),
    so every epoch of one path finds its capture.
    """

    def __init__(self, train_step):
        self.train_step = train_step
        self.captured = {}
        (self.last, self.epochs) = (None, 0)

    def __call__(self, state, dataset, rows, noise):
        if dataset.device.type != "cuda":
            raise RuntimeError(f"a graphed epoch runs on the card, not on {dataset.device}.")
        rows = torch.as_tensor(rows).to(torch.int64)
        check_noises(noise, rows.shape[0])
        form = (("generator", noise) if isinstance(noise, torch.Generator)
                else None if noise is None else _signature(noise[0]))
        key = (tuple(dataset.shape), dataset.dtype, dataset.device, tuple(rows.shape),
               tuple((tuple(leaf.shape), leaf.dtype, leaf.device)
                     for leaf in state_leaves(state)), form)
        self.epochs += 1
        args = {"epoch": self.epochs}
        entry = self.captured.get(key)
        if entry is None:
            program = EpochProgram(self.train_step, state, dataset, rows, noise)
            with phase("epoch.load", args):
                program.load(state, dataset, rows, noise)
            entry = self.captured[key] = _CapturedEpoch(program)
        else:
            with phase("epoch.load", args):
                entry.program.load(state, dataset, rows, noise)
        self.last = entry
        return entry.run(args)

    def phase_ms(self):
        """The last graphed epoch's median device milliseconds a step of
        each phase (:func:`phase_ms` of its stamps, one copy to the host),
        or None before the first."""
        if self.last is None:
            return None
        program = self.last.program
        return phase_ms(program.marks, program.stamps.cpu().numpy())


def epoch_fn(step):
    """``epoch(state, dataset, rows, noise)``: ``step`` over the
    ``(nb_batches, batch_size)`` rows of a device-resident dataset. For a
    state on the card, the replays of one captured step
    (:class:`GraphedEpoch`, whose captures live as long as the returned
    function); for a state on the CPU, the eager loop
    :func:`epoch_over_rows`. On the card the returned state shares no
    storage with the given one or with the graph. ``epoch.phase_ms()``
    is :meth:`GraphedEpoch.phase_ms` (None until an epoch ran graphed)."""
    graphed = GraphedEpoch(step)

    def epoch(state, dataset, rows, noise):
        if state_leaves(state)[0].is_cuda:
            return graphed(state, dataset, rows, noise)
        return epoch_over_rows(step, state, dataset, rows, noise)

    epoch.phase_ms = graphed.phase_ms
    return epoch
