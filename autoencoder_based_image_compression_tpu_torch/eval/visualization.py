"""Figures of the training, of the rate-distortion study and of the
model inspection: every figure of the reference package's
``eval/visualization.py``.

Normed latent histograms overlaid with the fitted piecewise-linear pdfs
(reference ``tools/tools.py:668-752``), conv-filter and latent-map
mosaics (``tools.py:1332-1358``, ``:1267-1290``), dead-maps-vs-rate
plots (``reconstructing_eae_kodak.py:245-287``), loss curves
(``training_eae_imagenet.py:259-326``), luminance mosaics and crops
(``tools.py:1172-1330``), and the SVHN side's digit mosaics, dead-latent
map and dense-weight tiles (``svhn/tools/tools.py:1342-1474``).

They take numpy arrays in the reference's layouts (conv kernels HWIO)
and draw on the host. ``matplotlib`` is imported where a figure is drawn
and PIL where an image file is written, so that a run that draws none
needs neither.
"""

import numpy


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_nb_dead_feature_maps(rates, nb_deads, path):
    """Dead-feature-map count vs rate (reference
    ``reconstructing_eae_kodak.py:245-287``).

    Accepts 1D arrays (one curve) or 2D ``(nb_points, nb_images)``
    arrays: the per-image curves are overlaid thin with the mean curve
    bold, so one figure carries the whole sweep.
    """
    plt = _pyplot()
    rates = numpy.asarray(rates)
    nb_deads = numpy.asarray(nb_deads)
    if nb_deads.ndim == 2:
        rates_2d = rates if rates.ndim == 2 else numpy.repeat(
            rates[:, None], nb_deads.shape[1], axis=1)
        plt.plot(rates_2d, nb_deads, "-", color="0.8", linewidth=0.6)
        plt.plot(numpy.mean(rates_2d, axis=1), numpy.mean(nb_deads, axis=1),
                 "o-", label="mean over images")
        plt.legend(loc="upper right")
    else:
        plt.plot(rates, nb_deads, "o-")
    plt.xlabel("rate (bpp)")
    plt.ylabel("number of dead feature maps")
    plt.title("Dead latent feature maps vs rate")
    plt.savefig(path)
    plt.clf()


def plot_training_curves(history, path):
    """Loss curves over epochs; ``history`` maps label -> list of values."""
    plt = _pyplot()
    for (label, values) in history.items():
        plt.plot(numpy.arange(len(values)), numpy.asarray(values), label=label)
    plt.xlabel("epoch")
    plt.legend()
    plt.title("Training indicators")
    plt.savefig(path)
    plt.clf()


def normed_histogram(data_per_map, grid, pdfs, titles, paths):
    """Normed histogram of each latent map overlaid with its fitted pdf:
    ``data_per_map[..., i]`` against ``pdfs[i, :]`` sampled on ``grid``
    (reference ``tools/tools.py:668-752``)."""
    plt = _pyplot()
    for i in range(len(paths)):
        plt.hist(numpy.asarray(data_per_map[..., i]).flatten(), bins=60, density=True)
        plt.plot(grid, pdfs[i, :], "r")
        plt.title(titles[i])
        plt.savefig(paths[i])
        plt.clf()


def _normed_mosaic(patches, nb_vertically):
    """Tiles ``(h, w, nb)`` patches, each rescaled to [0, 1], column by
    column with one-pixel gaps."""
    (height, width, nb) = patches.shape
    nb_horizontally = -(-nb // nb_vertically)
    mosaic = numpy.zeros(((height + 1) * nb_vertically, (width + 1) * nb_horizontally))
    for i in range(nb):
        (row, col) = (i % nb_vertically, i // nb_vertically)
        patch = patches[:, :, i]
        (lo, hi) = (patch.min(), patch.max())
        normed = (patch - lo) / (hi - lo) if hi > lo else numpy.zeros_like(patch)
        mosaic[row * (height + 1):row * (height + 1) + height,
               col * (width + 1):col * (width + 1) + width] = normed
    return mosaic


def visualize_weights(weights, nb_vertically, path):
    """Tiles conv filters ``(kh, kw, 1, nb)`` (HWIO) into one grayscale
    mosaic (reference ``tools/tools.py:1332-1358``)."""
    _pyplot().imsave(path, _normed_mosaic(weights[:, :, 0, :], nb_vertically), cmap="gray")


def visualize_representation(latents_hwc, nb_vertically, path):
    """Tiles the latent feature maps ``(h, w, nb)`` of one image into a
    mosaic (reference ``tools/tools.py:1267-1290``)."""
    _pyplot().imsave(path, _normed_mosaic(latents_hwc, nb_vertically), cmap="gray")


def histogram(data, title, path):
    """Plain 60-bin histogram (reference ``tools/tools.py:595-613``)."""
    plt = _pyplot()
    plt.hist(numpy.asarray(data).flatten(), bins=60)
    plt.title(title)
    plt.savefig(path)
    plt.clf()


def _bordered_mosaic(tiles, nb_vertically):
    """Places ``(nb, h, w[, 3])`` uint8 tiles row by row on a white
    ground with one-pixel separators (reference ``tools.py:1220-1265``)."""
    (nb_images, height, width) = tiles.shape[:3]
    nb_horizontally = -(-nb_images // nb_vertically)
    mosaic = 255 * numpy.ones((nb_vertically * (height + 1) + 1,
                               nb_horizontally * (width + 1) + 1) + tiles.shape[3:],
                              dtype=numpy.uint8)
    for i in range(nb_vertically):
        for j in range(nb_horizontally):
            idx = i * nb_horizontally + j
            if idx < nb_images:
                mosaic[i * (height + 1) + 1:(i + 1) * (height + 1),
                       j * (width + 1) + 1:(j + 1) * (width + 1)] = tiles[idx]
    return mosaic


def visualize_luminances(luminances_uint8, nb_vertically, path):
    """Arranges luminance images ``(N, H, W, 1)`` into one bordered mosaic
    (reference ``tools/tools.py:1220-1265``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    if luminances_uint8.dtype != numpy.uint8:
        raise TypeError("`luminances_uint8.dtype` is not equal to `numpy.uint8`.")
    if luminances_uint8.shape[3] != 1:
        raise ValueError("`luminances_uint8.shape[3]` is not equal to 1.")
    save_image(path, _bordered_mosaic(luminances_uint8[:, :, :, 0], nb_vertically))


def visualize_crops(image_uint8, positions_top_left, paths):
    """Saves 2x-magnified 80 x 80 crops of a luminance image;
    ``positions_top_left[:, i]`` is the (row, column) of the ith crop
    (reference ``tools/tools.py:1172-1218``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import (
        crop_repeat_2d,
        save_image,
    )

    (nb_rows, nb_crops) = positions_top_left.shape
    if nb_rows != 2:
        raise ValueError("`positions_top_left.shape[0]` is not equal to 2.")
    if len(paths) != nb_crops:
        raise ValueError("`len(paths)` is not equal to `positions_top_left.shape[1]`.")
    for i in range(nb_crops):
        save_image(paths[i], crop_repeat_2d(image_uint8, int(positions_top_left[0, i]),
                                            int(positions_top_left[1, i])))


def visualize_rotated_luminance(luminance_before_rotation_uint8, is_rotated,
                                positions_top_left, paths):
    """Rotates a sideways Kodak image back and saves it to ``paths[0]``
    and its crops to the rest (reference ``tools/tools.py:1292-1330``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    if is_rotated:
        image_uint8 = numpy.rot90(luminance_before_rotation_uint8, k=3).copy()
    else:
        image_uint8 = luminance_before_rotation_uint8.copy()
    visualize_crops(image_uint8, positions_top_left, paths[1:])
    save_image(paths[0], image_uint8)


def visualize_dead(quantized_samples, path):
    """Sign map of quantised latents: red > 0, black == 0, blue < 0 (the
    dense side's dead-latent picture, reference
    ``svhn/tools/tools.py:1342-1369``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    quantized_samples = numpy.asarray(quantized_samples)
    black = numpy.zeros(quantized_samples.shape + (1,), dtype=numpy.uint8)
    blue = black.copy()
    blue[quantized_samples < 0.0] = 255
    red = black.copy()
    red[quantized_samples > 0.0] = 255
    save_image(path, numpy.concatenate((red, black, blue), axis=2))


def visualize_images(images_uint8, nb_vertically, path):
    """Arranges RGB images ``(H, W, 3, N)`` into one bordered RGB mosaic
    (reference ``svhn/tools/tools.py:1370-1415``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    if images_uint8.dtype != numpy.uint8:
        raise TypeError("`images_uint8.dtype` is not equal to `numpy.uint8`.")
    if images_uint8.shape[2] != 3:
        raise ValueError("`images_uint8.shape[2]` is not equal to 3.")
    save_image(path, _bordered_mosaic(numpy.transpose(images_uint8, (3, 0, 1, 2)),
                                      nb_vertically))


def visualize_rows(rows_uint8, height_image, width_image, nb_vertically, path):
    """Planar rows -> RGB images -> their mosaic (reference
    ``svhn/tools/tools.py:1417-1442``)."""
    from autoencoder_based_image_compression_tpu_torch.utils.image import rows_to_images

    visualize_images(rows_to_images(rows_uint8, height_image, width_image), nb_vertically,
                     path)


def visualize_dense_weights(weights, height_image, width_image, nb_vertically, path):
    """Rescales dense weight rows to uint8 and mosaics them as RGB tiles
    (the SVHN side's weight picture, reference
    ``svhn/tools/tools.py:1444-1474``)."""
    weights = numpy.asarray(weights, dtype=numpy.float64)
    (min_w, max_w) = (numpy.amin(weights), numpy.amax(weights))
    scale = (max_w - min_w) if max_w > min_w else 1.0
    rows_uint8 = numpy.round(255.0 * (weights - min_w) / scale).astype(numpy.uint8)
    visualize_rows(rows_uint8, height_image, width_image, nb_vertically, path)
