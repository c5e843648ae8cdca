"""Named phases of the program, for a profiler and for a captured graph.

``phase(name)`` opens a profiler range named ``name`` over a block,
``mark(name)`` at one point (a range that closes at once), so that
eager, CPU and sharded runs show a profiler the same names. The range is
a host range: a function-scope record function (what an operator
records), whose ``args`` a profiler keeps as its keyword inputs when it
records shapes. A user annotation (``torch.profiler.record_function``)
would also be copied onto the card's timeline over every kernel it
encloses, where a reading of the trace would count it as device work:
over the graphed epochs' replays it hid the device's idle time.

A range the host opens while a CUDA graph is captured is never replayed.
So while the current stream captures a graphed epoch's step
(``train/epoch_graph.py``, which sets the :class:`Recorder`), ``phase``
and ``mark`` also launch the mark kernel of their name
(``aeic_mark_<name>`` in ``csrc/gdn.cu``) on the current stream. Every
replay then writes the card's global timer into the epoch's stamps at
(its step, the mark's slot), and a device trace shows where each phase
of each replayed step begins by the kernel's name. The marks are fixed
in the graph at its capture, so they cost the same in every replay,
traced or not.

The marks of a training step (:data:`MARKS`): ``step`` at the top of the
captured step (its phase is the batch's gather), ``density``,
``forward``, ``backward``, ``optimizer`` (Adam, the bin widths, the
projections and the write into the static buffers) and ``step_end``
before the step counter advances; these tile the step. Inside
``backward``, each GDN site's backward lies between
``gdn_backward_begin`` and ``gdn_backward_end``. A density pre-fit step
gives ``step``, ``density`` and ``step_end``. The scale hyperprior's
step (``train/hyperprior.py``) has no density phase and splits its
``forward`` with marks of its own (:data:`FORWARD_MARKS`): ``forward``
opens the analysis transform, ``entropy`` the hyper networks and both
likelihoods, ``synthesis`` the synthesis transform, the distortion and
the loss. Minnen et al.'s model (``models/minnen2018.py``) marks
``context`` between the two: ``entropy`` then holds the hyper networks
and ``z``'s likelihood, ``context`` the masked conv, the entropy
parameters and ``y``'s likelihood.
"""

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

# The marks that tile a step, in order; the phase each opens is named by
# the mark, but for ``step``'s, the gather.
STEP_MARKS = ("step", "density", "forward", "backward", "optimizer", "step_end")
GDN_BACKWARD = ("gdn_backward_begin", "gdn_backward_end")
# Marks inside ``forward``, in order, which they split; they tile nothing
# of their own. A step gives those its model has (``context`` only
# Minnen et al.'s).
FORWARD_MARKS = ("entropy", "context", "synthesis")
MARKS = STEP_MARKS + GDN_BACKWARD + FORWARD_MARKS

_recorder = None


class Recorder:
    """The marks of one captured step. At the warm-up step (no
    ``stamps`` yet) it lists their names in order; given the ``(rows,
    slots)`` int64 stamps and the step counter, it launches each mark of
    the capture onto the next slot (``launched`` counts them)."""

    def __init__(self):
        self.names = []
        self.stamps = None
        self.counter = None
        self.launched = 0


@contextlib.contextmanager
def recording(recorder):
    """``recorder`` takes the marks of the step run inside (on any
    thread: autograd runs a backward on its own)."""
    global _recorder
    _recorder = recorder
    try:
        yield recorder
    finally:
        _recorder = None


def _stamp(name):
    recorder = _recorder
    if recorder is None:
        return
    if name not in MARKS:
        raise ValueError(f"{name!r} is not a mark of a step ({', '.join(MARKS)}).")
    if recorder.stamps is None:
        recorder.names.append(name)
    elif torch.cuda.is_current_stream_capturing():
        # Imported here: the GDN kernels' module marks its backward with this one.
        from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
            launch_mark,
        )

        launch_mark(name, recorder.stamps, recorder.counter, recorder.launched)
        recorder.launched += 1


def mark(name):
    """A point of the program named ``name``."""
    with _RecordFunctionFast(name):
        _stamp(name)


@contextlib.contextmanager
def phase(name, args=None):
    """A block of the program named ``name``; ``args``, a dict of
    numbers, goes with the profiler's range."""
    with _RecordFunctionFast(name, [], args or {}):
        _stamp(name)
        yield
