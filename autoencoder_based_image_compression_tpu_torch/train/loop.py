"""Epoch loop and batched inference helpers.

Counterpart of the reference's batch loops
(``kodak_tensorflow/eae/batching.py``): uint8 images enter as raw
float32 in [0, 255] (no normalisation), mini-batches have a fixed size
that must divide the set, density pre-fit epochs come before the first
joint epoch, and each batch runs the density update THEN the autoencoder
update.

The training set is uploaded once as uint8
(:func:`device_resident_dataset`); every batch is gathered on the
device. All functions work on the device of the state or parameters
they are given. ``noise`` is a ``torch.Generator`` on that device (see
``train/step.py``).
"""

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.metrics import (
    average_entropies,
    convert_approx_entropy,
)
from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import rows_in_order
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.image import subdivide_set


def _params_device(params):
    return next(iter(params.values())).device


def _on_device(array, device):
    """A numpy array or tensor as a tensor on ``device``."""
    return torch.as_tensor(array).to(device)


@torch.no_grad()
def encode_mini_batches(luminances_uint8, params, learn_bin_widths, batch_size):
    """Latents of a stack of luminance images, one mini-batch at a time
    (reference ``eae/batching.py:56-100``). Returns float32 numpy
    ``(N, H/16, W/16, 128)``."""
    if luminances_uint8.dtype != numpy.uint8:
        raise TypeError("`luminances_uint8.dtype` is not equal to `numpy.uint8`.")
    nb_batches = subdivide_set(luminances_uint8.shape[0], batch_size)
    device = _params_device(params)
    chunks = []
    for i in range(nb_batches):
        batch = _on_device(luminances_uint8[i * batch_size:(i + 1) * batch_size], device)
        y = conv_eae.encode(params, batch.to(torch.float32), learn_bin_widths)
        chunks.append(y.cpu().numpy())
    return numpy.concatenate(chunks, axis=0)


@torch.no_grad()
def decode_mini_batches(quantized_y_float32, params, learn_bin_widths, batch_size):
    """uint8 reconstructions from quantised latents, one batch at a time
    (reference ``eae/batching.py:11-54``): the decoder's output is
    clipped to the BT.601 range and cast to uint8 on the device, so a
    quarter of the fp32 bytes comes back."""
    nb_batches = subdivide_set(quantized_y_float32.shape[0], batch_size)
    device = _params_device(params)
    chunks = []
    for i in range(nb_batches):
        batch = _on_device(quantized_y_float32[i * batch_size:(i + 1) * batch_size], device)
        chunks.append(cast_bt601(conv_eae.decode(params, batch, learn_bin_widths)).cpu().numpy())
    return numpy.concatenate(chunks, axis=0)


def device_resident_dataset(training_uint8, device="cuda"):
    """Uploads the uint8 training stack to the device once. The training
    loops gather mini-batch rows there and cast them to float32 inside
    the step, so a step sends a handful of row indices and no image."""
    return _on_device(training_uint8, resolve_device(device))


def preliminary_fitting(training_uint8, state, step_fns, batch_size, nb_epochs_fitting, noise):
    """Density pre-fit epochs before the first joint training epoch
    (reference ``eae/batching.py:102-127``): ``training_fct`` over the
    batches in the set's order. ``training_uint8`` may be a numpy stack
    or a :func:`device_resident_dataset` tensor. Each epoch is the step
    functions' ``fit_epoch``: the replays of one captured ``training_fct``
    on the card, the eager loop on the CPU."""
    nb_batches = subdivide_set(training_uint8.shape[0], batch_size)
    dataset = _on_device(training_uint8, state.step.device)
    rows = rows_in_order(nb_batches, batch_size)
    for _ in range(nb_epochs_fitting):
        state = step_fns["fit_epoch"](state, dataset, rows, noise)
    return state


def run_epoch_training(training_uint8, state, step_fns, batch_size, nb_batches, noise,
                       permutation=None):
    """One training epoch: shuffle, then the alternation per batch
    (reference ``eae/batching.py:129-165``). ``training_uint8`` may be a
    numpy stack or a :func:`device_resident_dataset` tensor."""
    if permutation is None:
        permutation = numpy.random.permutation(training_uint8.shape[0])
    dataset = _on_device(training_uint8, state.step.device)
    rows = numpy.asarray(permutation[:nb_batches * batch_size],
                         dtype=numpy.int64).reshape(nb_batches, batch_size)
    return step_fns["train_epoch"](state, dataset, rows, noise)


def phase_line(train_epoch):
    """The operator's line of the last graphed epoch of ``train_epoch``
    (a step functions' ``train_epoch``): the median device milliseconds
    a step of each phase, read from the epoch's stamps
    (``train/epoch_graph.py``); None where no epoch ran graphed (the
    CPU)."""
    phases = train_epoch.phase_ms()
    if phases is None:
        return None
    inner = {"forward": f" (entropy {phases['entropy']:.3f})" if "entropy" in phases else "",
             "backward": (f" (GDN backward {phases['gdn_backward']:.3f})"
                          if "gdn_backward" in phases else "")}
    parts = [f"{name} {phases[name]:.3f}" + inner.get(name, "")
             for name in ("gather", "density", "forward", "backward", "optimizer")
             if name in phases]
    return f"Device ms a step by phase: {', '.join(parts)}; step {phases['step']:.3f}"


def evaluate(state, batch_uint8, step_fns, gamma_scaling, noise):
    """The reference's four training indicators on one batch:
    ``(mean_discrete_entropy, scaled_approx_entropy, rec_error,
    loss_density_approx)`` (``EntropyAutoencoder.py:542-589``)."""
    full = evaluate_full(state, batch_uint8, step_fns, gamma_scaling, noise)
    return (full["mean_disc_entropy"], full["scaled_approx_entropy"],
            full["rec_error"], full["loss_density"])


def evaluate_full(state, batch_uint8, step_fns, gamma_scaling, noise):
    """The reference's complete per-epoch indicator set on one batch.

    Reference ``training_eae_imagenet.py:121-201`` prints, per epoch and
    per train/val portion: mean approximate entropy, mean discrete
    entropy, their gap, scaled cumulated approximate entropy,
    reconstruction error, density-fit loss; plus the shared weight
    decay. This returns one portion's dict, with what the monitors
    need besides: the UNCLAMPED per-map approximate entropies, the areas
    under the live pdfs, and the count of maps that quantise to zero
    across the whole portion.
    """
    batch = _on_device(batch_uint8, state.step.device)
    (scaled_approx_entropy, rec_error, loss_density, y, approx_per_map, areas,
     weight_decay) = step_fns["evaluation"](state, batch, noise)
    bin_widths = state.bin_widths.cpu().numpy()
    y_host = y.cpu().numpy()
    mean_disc_entropy = average_entropies(y_host, bin_widths)
    scaled_approx_entropy = float(scaled_approx_entropy)
    mean_approx_entropy = convert_approx_entropy(scaled_approx_entropy, gamma_scaling,
                                                 csts.NB_MAPS_3)
    quantized = bin_widths * numpy.round(y_host / bin_widths)
    return {
        "mean_approx_entropy": mean_approx_entropy,
        "mean_disc_entropy": mean_disc_entropy,
        "entropy_gap": mean_disc_entropy - mean_approx_entropy,
        "scaled_approx_entropy": scaled_approx_entropy,
        "rec_error": float(rec_error),
        "loss_density": float(loss_density),
        "weight_decay": float(weight_decay),
        "approx_entropy_per_map": approx_per_map.cpu().numpy(),
        "areas_under_pdfs": areas.cpu().numpy(),
        "nb_dead_maps": int(numpy.count_nonzero(
            numpy.sum(numpy.abs(quantized), axis=(0, 1, 2)) == 0.0)),
    }
