"""Continuous batching of images through the codec.

Counterpart of the reference's ``parallel/continuous_batching.py``:
images arrive as a stream; the batcher packs them into
batches of one fixed size, pads the last partial batch, keeps several
batches in flight and hands each finished image to a completion
callback, under which the caller typically runs the host arithmetic
coder while the device computes the next batch.

"In flight" on the card means queued on the batcher's stream with the
device-to-host copy of the result into pinned memory and a CUDA event
behind it (``parallel.inference.Fetch``); draining a batch waits on
that event alone, not on the whole device.
"""

import collections
import contextlib
import threading

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    Fetch,
    make_codec_fns,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device


class ContinuousBatcher:
    """Streams images through a batch function.

    Completed images are delivered through ``on_complete(image_id,
    output)`` as batches drain (called from whichever thread triggers
    the drain: ``submit`` under in-flight back-pressure, or ``flush``);
    without a callback they accumulate and ``flush`` returns them all.

    The device work is queued outside the queue lock: ``submit`` holds
    that lock only to append or to claim a full batch, so concurrent
    producers never wait behind a device call.

    Parameters
    ----------
    batch_fn : callable
        ``(images_f32 (B, H, W, C) CPU tensor) -> outputs``, a tensor on
        any device whose first axis is the batch. It queues its work on
        the current stream and does not wait for it.
    batch_size : int
        Device batch size B.
    max_in_flight : int
        Number of queued-but-unfetched batches allowed (bounds device
        and pinned memory while keeping the device fed).
    on_complete : callable, optional
        ``on_complete(image_id, output_row)`` (a numpy array) invoked
        once per image as its batch is fetched. When set, ``flush``
        returns ``{}``.
    stream : torch.cuda.Stream, optional
        The stream every batch is queued on. PyTorch's current stream
        belongs to a thread, so with several producer threads on the
        card pass one here: each ``batch_fn`` call and its fetch then
        run under ``torch.cuda.stream(stream)``, in dispatch order.
        None leaves the calling thread's current stream (and is what a
        CPU ``batch_fn`` takes).
    """

    def __init__(self, batch_fn, batch_size, max_in_flight=2, on_complete=None,
                 stream=None):
        self.batch_fn = batch_fn
        self.batch_size = batch_size
        self.max_in_flight = max_in_flight
        self.on_complete = on_complete
        self.stream = stream
        self._pending = []          # images waiting to fill a batch
        self._pending_ids = []
        self._in_flight = collections.deque()  # (ids, Fetch)
        self._results = {}
        self._queue_lock = threading.Lock()     # guards _pending*
        self._device_lock = threading.Lock()    # guards _in_flight + dispatch order

    def submit(self, image_id, image_f32):
        """Enqueues one image; dispatches when a batch fills."""
        with self._queue_lock:
            self._pending.append(image_f32)
            self._pending_ids.append(image_id)
            if len(self._pending) < self.batch_size:
                return
            batch = numpy.stack(self._pending, axis=0)
            ids = list(self._pending_ids)
            self._pending = []
            self._pending_ids = []
        self._dispatch(batch, ids)

    def _dispatch(self, batch, ids):
        """Queues one assembled batch, draining under back-pressure.

        Serialised by ``_device_lock`` so that completion order follows
        dispatch order; the queue lock is not held here.
        """
        with self._device_lock:
            while len(self._in_flight) >= self.max_in_flight:
                self._drain_one_locked()
            context = (contextlib.nullcontext() if self.stream is None
                       else torch.cuda.stream(self.stream))
            with context:
                fetch = Fetch(self.batch_fn(torch.from_numpy(batch)))
            self._in_flight.append((ids, fetch))

    def _drain_one_locked(self):
        (ids, fetch) = self._in_flight.popleft()
        (host,) = fetch.wait()   # blocks until this batch's copy is done
        host = host.numpy()
        for (i, image_id) in enumerate(ids):
            # Rows past len(ids) are flush padding: dropped here.
            if self.on_complete is not None:
                self.on_complete(image_id, host[i])
            else:
                self._results[image_id] = host[i]

    def flush(self):
        """Dispatches the partial batch (padded) and drains everything.

        Returns ``{image_id: output}`` for the images not already
        delivered through ``on_complete``.
        """
        with self._queue_lock:
            batch = None
            if self._pending:
                nb_real = len(self._pending)
                pad = self.batch_size - nb_real
                template = numpy.zeros_like(self._pending[0])
                self._pending.extend([template] * pad)
                batch = numpy.stack(self._pending, axis=0)
                ids = list(self._pending_ids[:nb_real])
                self._pending = []
                self._pending_ids = []
        if batch is not None:
            self._dispatch(batch, ids)
        with self._device_lock:
            while self._in_flight:
                self._drain_one_locked()
            results = dict(self._results)
            self._results.clear()
            return results


def stream_roundtrip(params, bin_widths, images_uint8, batch_size, learn_bin_widths=True,
                     mesh=None, max_in_flight=2, device="cuda"):
    """Streams a uint8 stack through encode + quantise + decode (the
    fp32 transforms of ``make_codec_fns``), on ``device`` or over
    ``mesh`` (each batch split over its ``data`` axis, the batch's
    reconstructions gathered whole before they are fetched).

    ``params`` is the dict of ``train.checkpoint.params_from_jax``.
    Returns the float32 reconstructions in submission order.
    """
    if mesh is not None:
        device = mesh.device_of("data", mesh.local_indices("data")[0])
    device = resolve_device(device)
    (encode_fn, decode_fn, put) = make_codec_fns(learn_bin_widths, mesh, device=device)
    params = {name: value.to(device) for (name, value) in params.items()}
    bw = torch.tensor(numpy.asarray(bin_widths, numpy.float32)).to(device)

    def batch_fn(batch):
        out = decode_fn(params, encode_fn(params, put(batch)), bw)
        return out if mesh is None else out.gather(device)

    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    batcher = ContinuousBatcher(batch_fn, batch_size, max_in_flight, stream=stream)
    for (i, image) in enumerate(images_uint8):
        batcher.submit(i, image.astype(numpy.float32))
    results = batcher.flush()
    return numpy.stack([results[i] for i in range(len(images_uint8))], axis=0)
