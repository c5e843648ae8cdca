"""Host-side image helpers: BT.601 luminance and image saving.

Numpy counterparts of the reference's ``tools/tools.py:1019-1106``.
PIL is imported where an image file is written, so the codec's device
path does not need it.
"""

import numpy


def rgb_to_ycbcr(rgb_uint8):
    """ITU-R BT.601 RGB -> YCbCr (matches Matlab's ``rgb2ycbcr``).

    Luminance spans [16, 235], chrominance [16, 240].
    """
    if rgb_uint8.dtype != numpy.uint8:
        raise TypeError("`rgb_uint8.dtype` is not equal to `numpy.uint8`.")
    if rgb_uint8.ndim != 3 or rgb_uint8.shape[2] != 3:
        raise ValueError("`rgb_uint8` must have shape (H, W, 3).")
    rgb = rgb_uint8.astype(numpy.float64)
    y = 16.0 + (65.481 * rgb[:, :, 0] + 128.553 * rgb[:, :, 1] + 24.966 * rgb[:, :, 2]) / 255.0
    cb = 128.0 + (-37.797 * rgb[:, :, 0] - 74.203 * rgb[:, :, 1] + 112.0 * rgb[:, :, 2]) / 255.0
    cr = 128.0 + (112.0 * rgb[:, :, 0] - 93.786 * rgb[:, :, 1] - 18.214 * rgb[:, :, 2]) / 255.0
    ycbcr = numpy.stack((y, cb, cr), axis=2)
    return numpy.round(ycbcr.clip(0.0, 255.0)).astype(numpy.uint8)


def luminance_bt601(rgb_uint8):
    """Extracts the BT.601 luminance channel of an RGB image."""
    return rgb_to_ycbcr(rgb_uint8)[:, :, 0]


def save_image(path, array_uint8):
    """Saves a uint8 array as an image file."""
    import PIL.Image

    if array_uint8.dtype != numpy.uint8:
        raise TypeError("`array_uint8.dtype` is not equal to `numpy.uint8`.")
    PIL.Image.fromarray(array_uint8).save(path)


def subdivide_set(nb_examples, batch_size):
    """Number of full mini-batches; raises when not divisible
    (reference ``tools/tools.py:1108-1132``)."""
    if nb_examples % batch_size != 0:
        raise ValueError("`nb_examples` is not divisible by `batch_size`.")
    return nb_examples // batch_size
