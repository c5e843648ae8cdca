"""Rate-distortion sweeps.

Counterpart of ``kodak_tensorflow/reconstructing_eae_kodak.py``: the
three learned-codec curve families

- one model per gamma with fixed unit bin widths (``:401-556``,
  "vary_gamma_fix_bin_widths"),
- one learned-bin-width model swept over bin-width multipliers
  (``:31-243``, "fix_gamma" learn_bw=True),
- one fixed-bin-width model swept over multipliers ("fix_gamma"
  learn_bw=False),

plus the Bjontegaard summaries against the anchors. Every curve is
cached to ``.npy`` and skipped on re-run (reference ``:678-683``:
"Delete them manually to re-compute"); the file names are the reference
package's, so either package reads the other's cache directory.

The transforms run on the device of the parameters they are given;
centring, quantisation, rates and PSNRs are host numpy, as in the
reference.
"""

import os
import pickle

import numpy

from autoencoder_based_image_compression_tpu_torch.coding.compression import (
    rescale_compress_lossless_maps,
)
from autoencoder_based_image_compression_tpu_torch.ops.metrics import (
    bjontegaard_fit_quality,
    compute_bjontegaard,
    count_nb_deads,
    psnr_2d,
    rate_3d,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import (
    decode_mini_batches,
    encode_mini_batches,
)


def compute_rate_psnr(luminances_uint8, params, bin_widths_test, learn_bin_widths,
                      batch_size, map_mean=None, binary_probabilities=None,
                      idx_map_exception=-1):
    """Rates and PSNRs of a stack of images at one operating point.

    Encode once, quantise per map (centring by the extra-set map means
    when provided, reference ``:170-213``), decode, PSNR on uint8. Rate
    is the true coded rate when ``binary_probabilities`` is given (via
    the C++ coder) and the theoretical entropy rate otherwise.
    ``params`` are tensors in this package's layouts. Returns ``(rates,
    psnrs, reconstructions_uint8, nb_deads)``.
    """
    (nb_images, h_in, w_in) = luminances_uint8.shape[:3]
    images = luminances_uint8.reshape(nb_images, h_in, w_in, 1)
    y = encode_mini_batches(images, params, learn_bin_widths, batch_size)
    bin_widths_test = numpy.asarray(bin_widths_test, dtype=numpy.float32)
    centered = y if map_mean is None else y - map_mean.reshape(1, 1, 1, -1)
    centered_quantized = bin_widths_test * numpy.round(centered / bin_widths_test)
    nb_deads = count_nb_deads(centered_quantized)
    quantized_y = (centered_quantized if map_mean is None
                   else centered_quantized + map_mean.reshape(1, 1, 1, -1))
    reconstructions = decode_mini_batches(quantized_y, params, learn_bin_widths,
                                          batch_size)[:, :, :, 0]
    rates = numpy.zeros(nb_images)
    psnrs = numpy.zeros(nb_images)
    for i in range(nb_images):
        if binary_probabilities is not None:
            nb_bits = rescale_compress_lossless_maps(
                centered_quantized[i], bin_widths_test, binary_probabilities,
                idx_map_exception)
            rates[i] = float(nb_bits) / (h_in * w_in)
        else:
            rates[i] = rate_3d(centered_quantized[i], bin_widths_test, h_in, w_in)
        psnrs[i] = psnr_2d(luminances_uint8[i].reshape(h_in, w_in), reconstructions[i])
    return (rates, psnrs, reconstructions, nb_deads)


def fix_gamma(luminances_uint8, params, bin_widths, learn_bin_widths, multipliers,
              batch_size, cache_dir, map_mean=None, binary_probabilities_per_mult=None,
              idx_map_exception=-1, experiment_id=""):
    """Single-model bin-width-multiplier sweep (reference ``:31-243``).

    Returns ``(rates, psnrs, nb_deads)``, each of shape
    (nb_multipliers, nb_images); ``nb_deads`` counts the dead latent
    feature maps per operating point the way the reference's
    ``array_nb_deads`` does (``reconstructing_eae_kodak.py:162-191``).
    Cached under ``cache_dir``. ``experiment_id`` must encode the model
    identity (bin-width init, gamma, training step, multiplier set,
    coded-vs-theoretical rate) so that re-running with a different model
    cannot return a stale curve.
    """
    suffix = "learn" if learn_bin_widths else "fixed"
    if experiment_id:
        suffix = f"{suffix}_{experiment_id}"
    paths = [os.path.join(cache_dir, f"{kind}_fix_gamma_{suffix}.npy")
             for kind in ("rates", "psnrs", "deads")]
    if all(os.path.isfile(path) for path in paths):
        return tuple(numpy.load(path) for path in paths)
    nb_images = luminances_uint8.shape[0]
    rates = numpy.zeros((len(multipliers), nb_images))
    psnrs = numpy.zeros((len(multipliers), nb_images))
    nb_deads = numpy.zeros((len(multipliers), nb_images), dtype=numpy.int32)
    for (k, multiplier) in enumerate(multipliers):
        bin_widths_test = numpy.float32(multiplier) * numpy.asarray(bin_widths)
        probabilities = (None if binary_probabilities_per_mult is None
                         else binary_probabilities_per_mult[k])
        (rates[k], psnrs[k], _, nb_deads[k]) = compute_rate_psnr(
            luminances_uint8, params, bin_widths_test, learn_bin_widths,
            batch_size, map_mean, probabilities, idx_map_exception)
    os.makedirs(cache_dir, exist_ok=True)
    for (path, array) in zip(paths, (rates, psnrs, nb_deads)):
        numpy.save(path, array)
    return (rates, psnrs, nb_deads)


def vary_gamma_fix_bin_widths(luminances_uint8, params_per_gamma, gammas, batch_size,
                              cache_dir, experiment_id=""):
    """One fixed-bin-width model per gamma (reference ``:401-556``).

    ``params_per_gamma`` maps gamma -> trained parameter dict. Returns
    ``(rates, psnrs)`` of shape (nb_gammas, nb_images).
    ``experiment_id`` must encode the gamma ladder and the models'
    training steps (see :func:`fix_gamma`).
    """
    tag = f"_{experiment_id}" if experiment_id else ""
    path_rates = os.path.join(cache_dir, f"rates_vary_gamma{tag}.npy")
    path_psnrs = os.path.join(cache_dir, f"psnrs_vary_gamma{tag}.npy")
    if os.path.isfile(path_rates) and os.path.isfile(path_psnrs):
        return (numpy.load(path_rates), numpy.load(path_psnrs))
    nb_images = luminances_uint8.shape[0]
    rates = numpy.zeros((len(gammas), nb_images))
    psnrs = numpy.zeros((len(gammas), nb_images))
    unit_bin_widths = numpy.ones(128, dtype=numpy.float32)
    for (k, gamma) in enumerate(gammas):
        (rates[k], psnrs[k], _, _) = compute_rate_psnr(
            luminances_uint8, params_per_gamma[gamma], unit_bin_widths, False, batch_size)
    os.makedirs(cache_dir, exist_ok=True)
    numpy.save(path_rates, rates)
    numpy.save(path_psnrs, psnrs)
    return (rates, psnrs)


def bjontegaard_summary(rates_eae, psnrs_eae, rates_anchor, psnrs_anchor, path=None):
    """Mean-curve Bjontegaard saving of the EAE vs one anchor.

    Averages per-image curves first like the reference's dictionary
    construction (``:837-856``): the EAE arrays are (points, images),
    the anchor's (images, points). Optionally pickles the result.
    """
    args = (numpy.mean(rates_anchor, axis=0), numpy.mean(psnrs_anchor, axis=0),
            numpy.mean(rates_eae, axis=1), numpy.mean(psnrs_eae, axis=1))
    delta = compute_bjontegaard(*args)
    if path is not None:
        with open(path, "wb") as file:
            pickle.dump({"bjontegaard_percent_saving": delta,
                         "fit_quality": bjontegaard_fit_quality(*args)}, file)
    return delta


def plot_rate_distortion(curves, title, path):
    """Overlays RD curves and saves the figure (reference ``:289-399``).

    ``curves`` is a list of ``(rates_1d, psnrs_1d, label, style)``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for (rates, psnrs, label, style) in curves:
        order = numpy.argsort(rates)
        plt.plot(numpy.asarray(rates)[order], numpy.asarray(psnrs)[order],
                 style, label=label)
    plt.xlabel("rate (bpp)")
    plt.ylabel("PSNR (dB)")
    plt.title(title)
    plt.legend(loc="lower right")
    plt.savefig(path)
    plt.clf()
