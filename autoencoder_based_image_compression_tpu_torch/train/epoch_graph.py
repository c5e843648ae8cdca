"""The training epoch as replays of one captured CUDA graph.

Counterpart of the JAX package's scanned epoch (``train/step.py:206-232``
and the ladder's ``train/ladder.py:125-141``): there the whole shuffled
epoch is one ``lax.scan`` that gathers each batch from the
device-resident uint8 dataset inside its body. Here one training step is
captured once into a ``torch.cuda.CUDAGraph`` over static inputs, and an
epoch is ``nb_batches`` replays of it with no host work between them.

**Static inputs** (:class:`EpochProgram`): the state's buffers, the
dataset, the ``(nb_batches, batch_size)`` int64 rows, a device step
counter and the noise: a CUDA ``torch.Generator``, registered with the
graph so that every replay draws on from where the generator stands, or
one ``train_step`` noise per batch, stacked in device buffers. The
captured step gathers ``dataset.index_select(0,
rows.index_select(0, counter))``, runs the unchanged ``train_step`` on
the buffers, writes the new state into them with ``copy_`` and advances
the counter. Everything that needs the host (converting the rows,
checking the noise) happens before the first replay.

**Per epoch** the state, the dataset and the rows go in with one device
copy each (the noise too, when it is given per batch), the graph
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
"""

import time

import torch

from autoencoder_based_image_compression_tpu_torch.train.state import (
    clone_state,
    copy_state_into,
    state_leaves,
)

# Every capture of this process, in order: what it cost and holds.
CAPTURES = []


def check_noises(noise, nb_batches):
    """Raises unless ``noise`` is a generator or one noise per batch."""
    if not isinstance(noise, torch.Generator) and len(noise) != nb_batches:
        raise ValueError(f"{len(noise)} noises for {nb_batches} batches.")


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
    """

    def __init__(self, train_step, state, dataset, rows, noise):
        self.train_step = train_step
        device = dataset.device
        self.buffers = clone_state(state)
        self.dataset = torch.empty_like(dataset)
        self.rows = torch.empty(tuple(rows.shape), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        if isinstance(noise, torch.Generator):
            (self.generator, self.template, self.noise) = (noise, None, [])
        else:
            (self.generator, self.template) = (None, noise[0])
            self.noise = [torch.empty((len(noise), *leaf.shape), dtype=leaf.dtype,
                                      device=device) for leaf in _noise_leaves(noise[0])]

    @property
    def nb_batches(self):
        return self.rows.shape[0]

    def load(self, state, dataset, rows, noise):
        """An epoch's inputs into the static buffers, the counter to 0."""
        copy_state_into(self.buffers, state)
        self.dataset.copy_(dataset)
        self.rows.copy_(rows)
        self.counter.zero_()
        if self.generator is None:
            (targets, sources) = ([], [])
            for (i, batch_noise) in enumerate(noise):
                for (buffer, leaf) in zip(self.noise, _noise_leaves(batch_noise)):
                    targets.append(buffer[i])
                    sources.append(leaf)
            torch._foreach_copy_(targets, sources)

    def step(self, buffers, counter, generator=None):
        """One training step on batch ``counter`` of the rows: the new
        state is written into ``buffers``, and ``counter`` advances."""
        batch = self.dataset.index_select(0, self.rows.index_select(0, counter).reshape(-1))
        if self.generator is not None:
            noise = self.generator if generator is None else generator
        else:
            noise = _noise_like(self.template,
                                iter([buffer.index_select(0, counter)[0]
                                      for buffer in self.noise]))
        copy_state_into(buffers, self.train_step(buffers, batch, noise))
        counter.add_(1)


class _CapturedEpoch:
    """An :class:`EpochProgram` with its step captured in a CUDA graph."""

    def __init__(self, program):
        if torch.backends.cudnn.deterministic:
            raise RuntimeError(
                "train_epoch would capture its graph with "
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
        with torch.cuda.stream(side):
            program.step(scratch, counter, generator)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        del scratch, counter, generator
        warmup_s = time.perf_counter() - t0
        self.graph = torch.cuda.CUDAGraph()
        if program.generator is not None:
            self.graph.register_generator_state(program.generator)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            program.step(program.buffers, program.counter)
        torch.cuda.synchronize(device)
        CAPTURES.append({"warmup_s": warmup_s, "capture_s": time.perf_counter() - t0,
                         "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
                         "nb_batches": program.nb_batches,
                         "batch_size": program.rows.shape[1],
                         "noise": "generator" if program.generator is not None
                         else "per batch"})

    def run(self):
        for _ in range(self.program.nb_batches):
            self.graph.replay()
        return clone_state(self.program.buffers)


class GraphedEpoch:
    """``train_epoch(state, dataset, rows, noise)`` of one ``train_step``
    on the card, as replays of a captured graph.

    Captures are kept by (dataset shape, the rows' shape, the state's
    shapes and dtypes, the noise form: which generator, or the shapes of
    a batch's noise), and live as long as this object, which the step
    functions of ``make_step_fns`` / ``make_ladder_step_fns`` hold.
    """

    def __init__(self, train_step):
        self.train_step = train_step
        self.captured = {}

    def __call__(self, state, dataset, rows, noise):
        if dataset.device.type != "cuda":
            raise RuntimeError(f"a graphed epoch runs on the card, not on {dataset.device}.")
        rows = torch.as_tensor(rows).to(torch.int64)
        check_noises(noise, rows.shape[0])
        form = (("generator", noise) if isinstance(noise, torch.Generator)
                else _signature(noise[0]))
        key = (tuple(dataset.shape), dataset.dtype, dataset.device, tuple(rows.shape),
               tuple((tuple(leaf.shape), leaf.dtype, leaf.device)
                     for leaf in state_leaves(state)), form)
        entry = self.captured.get(key)
        if entry is None:
            program = EpochProgram(self.train_step, state, dataset, rows, noise)
            program.load(state, dataset, rows, noise)
            entry = self.captured[key] = _CapturedEpoch(program)
        else:
            entry.program.load(state, dataset, rows, noise)
        return entry.run()
