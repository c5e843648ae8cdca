"""Latent-space analysis probes.

Counterpart of the reference package's ``eval/analysis.py``, a redesign
of ``kodak_tensorflow/eae/analysis.py``: single-latent activation
through the decoder (``:17``, the translation-covariance probe of
``activating_eae.py``), per-map Laplace MLE fits (``:97``,
``fitting_eae_kodak.py``) and all-but-one map masking (``:191``,
``masking_eae_kodak.py``). The SVHN joint fit
(``svhn/eae/analysis.py:13``) is :func:`fit_latents_jointly`.

The probes decode on the parameters' device through ``conv_eae.decode``
(so through the IGDN kernels on the card) and return uint8 numpy arrays;
writing them as images is the command line's business.
"""

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601


def _decode_uint8(params, latents, learn_bin_widths):
    """uint8 reconstructions ``(B, H, W)`` of float32 numpy latents."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        reconstruction = conv_eae.decode(params, torch.from_numpy(latents).to(device),
                                         learn_bin_widths)
        return cast_bt601(reconstruction).cpu().numpy()[:, :, :, 0]


def activate_latent_variable(params, learn_bin_widths, height_map, width_map,
                             row_activation, col_activation, idx_map_activation,
                             activation_value, map_mean):
    """Decodes latents that are all at their map means except one.

    Returns the uint8 reconstruction ``(16 * height_map, 16 * width_map)``
    (reference ``eae/analysis.py:17-95``).
    """
    latents = numpy.tile(map_mean.reshape(1, 1, 1, -1),
                         (1, height_map, width_map, 1)).astype(numpy.float32)
    latents[0, row_activation, col_activation, idx_map_activation] = activation_value
    return _decode_uint8(params, latents, learn_bin_widths)[0]


def fit_maps(y_float32):
    """Per-map Laplace MLE fits of the latent distributions.

    Returns ``(locations, scales)`` arrays of length nb_maps (reference
    ``eae/analysis.py:97-189``; scipy's MLE, like the reference).
    """
    import scipy.stats

    nb_maps = y_float32.shape[3]
    locations = numpy.zeros(nb_maps)
    scales = numpy.zeros(nb_maps)
    for i in range(nb_maps):
        (locations[i], scales[i]) = scipy.stats.laplace.fit(y_float32[:, :, :, i].flatten())
    return (locations, scales)


def fit_latents_jointly(y_float32):
    """Single Laplace fit of all latents (reference ``svhn/eae/analysis.py:13``)."""
    import scipy.stats

    return scipy.stats.laplace.fit(numpy.asarray(y_float32).flatten())


def mask_maps(y_float32, params, learn_bin_widths, idx_unmasked, map_mean):
    """Decodes with every map except one frozen at its mean.

    Returns uint8 reconstructions ``(B, H, W)`` (reference
    ``eae/analysis.py:191-257``).
    """
    masked = numpy.tile(map_mean.reshape(1, 1, 1, -1),
                        y_float32.shape[:3] + (1,)).astype(numpy.float32)
    masked[:, :, :, idx_unmasked] = y_float32[:, :, :, idx_unmasked]
    return _decode_uint8(params, masked, learn_bin_widths)
