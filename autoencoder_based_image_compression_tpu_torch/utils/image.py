"""Host-side image utilities: colour conversion, crops, I/O.

Numpy counterparts of the image helpers in the reference
(``kodak_tensorflow/tools/tools.py``): BT.601 colour conversion
(``:1019-1080``), crops (``:390-484``), image read/save
(``:991-1106``). PIL is imported where an image file is read or
written, so the codec's device path does not need it.
"""

import os
import tarfile

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


def crop_option_2d(luminance_uint8, width_crop, is_random, rng=None):
    """Square crop: uniformly random position or centred.

    Reference ``tools/tools.py:390-432``; the RNG is injected instead of
    global ``numpy.random`` so dataset builds are reproducible.
    """
    if luminance_uint8.dtype != numpy.uint8:
        raise TypeError("`luminance_uint8.dtype` is not equal to `numpy.uint8`.")
    (height_image, width_image) = luminance_uint8.shape
    if height_image < width_crop or width_image < width_crop:
        raise ValueError("The image is smaller than the crop width.")
    if is_random:
        rng = rng if rng is not None else numpy.random.default_rng()
        i = int(rng.integers(height_image - width_crop + 1))
        j = int(rng.integers(width_image - width_crop + 1))
    else:
        i = (height_image - width_crop) // 2
        j = (width_image - width_crop) // 2
    return luminance_uint8[i:i + width_crop, j:j + width_crop]


def crop_repeat_2d(image_uint8, row_top_left, column_top_left):
    """80x80 crop whose pixels are repeated 2x in each direction.

    Visualisation helper (reference ``tools/tools.py:434-484``).
    """
    if image_uint8.dtype != numpy.uint8:
        raise TypeError("`image_uint8.dtype` is not equal to `numpy.uint8`.")
    (height_image, width_image) = image_uint8.shape
    if row_top_left + 80 >= height_image:
        raise ValueError("Crop rows exceed the image height.")
    if column_top_left + 80 >= width_image:
        raise ValueError("Crop columns exceed the image width.")
    crop = image_uint8[row_top_left:row_top_left + 80, column_top_left:column_top_left + 80]
    return numpy.repeat(numpy.repeat(crop, 2, axis=0), 2, axis=1)


def read_image_mode(path, mode):
    """Reads an image, enforcing its PIL mode (e.g. 'RGB' or 'L').

    Reference ``tools/tools.py:991-1017``; rejects e.g. CMYK inputs.
    """
    import PIL.Image

    image = PIL.Image.open(path)
    if image.mode != mode:
        raise ValueError(f"The image mode is {image.mode} whereas the given mode is {mode}.")
    return numpy.asarray(image)


def save_image(path, array_uint8):
    """Saves a uint8 array as an image file."""
    import PIL.Image

    if array_uint8.dtype != numpy.uint8:
        raise TypeError("`array_uint8.dtype` is not equal to `numpy.uint8`.")
    PIL.Image.fromarray(array_uint8).save(path)


def images_to_rows(images_uint8):
    """Reshapes each RGB image (H, W, 3, N) to a planar row (N, 3*H*W).

    Inverse of :func:`rows_to_images`; channel planes are laid out
    consecutively per row (reference ``svhn/tools/tools.py:563-607``).
    """
    if images_uint8.dtype != numpy.uint8:
        raise TypeError("`images_uint8.dtype` is not equal to `numpy.uint8`.")
    (height_image, width_image, nb_channels, nb_images) = images_uint8.shape
    if nb_channels != 3:
        raise ValueError("`images_uint8.shape[2]` is not equal to 3.")
    return numpy.ascontiguousarray(
        numpy.transpose(images_uint8, (3, 2, 0, 1))).reshape(nb_images, -1)


def rows_to_images(rows_uint8, height_image, width_image):
    """Reshapes each planar row back to an RGB image (H, W, 3, N).

    Inverse of :func:`images_to_rows` (reference
    ``svhn/tools/tools.py:1212-1262``).
    """
    if rows_uint8.dtype != numpy.uint8:
        raise TypeError("`rows_uint8.dtype` is not equal to `numpy.uint8`.")
    (nb_images, nb_pixels_per_row) = rows_uint8.shape
    if nb_pixels_per_row != 3 * height_image * width_image:
        raise ValueError(
            "`rows_uint8.shape[1]` is not equal to `3*height_image*width_image`.")
    planes = rows_uint8.reshape(nb_images, 3, height_image, width_image)
    return numpy.ascontiguousarray(numpy.transpose(planes, (2, 3, 1, 0)))


def clean_sort_list_strings(list_strings, extension):
    """Keeps the strings ending with the given extension(s), sorted.

    Deterministic dataset-file ordering (reference
    ``tools/tools.py:135-156``); ``extension`` may be a str or a tuple.
    """
    return sorted(string for string in list_strings if string.endswith(extension))


def untar_archive(path_to_folder_extraction, path_to_tar):
    """Extracts a local tar archive (any compression ``tarfile``
    handles; reference ``tools/tools.py:1157-1170``). Refuses members
    that would land outside the extraction folder."""
    root = os.path.realpath(path_to_folder_extraction)
    with tarfile.open(path_to_tar) as archive:
        for member in archive.getmembers():
            target = os.path.realpath(os.path.join(root, member.name))
            if not (target == root or target.startswith(root + os.sep)):
                raise ValueError(f"Unsafe tar member path: {member.name}")
        archive.extractall(root, filter="data")


def subdivide_set(nb_examples, batch_size):
    """Number of full mini-batches; raises when not divisible
    (reference ``tools/tools.py:1108-1132``)."""
    if nb_examples % batch_size != 0:
        raise ValueError("`nb_examples` is not divisible by `batch_size`.")
    return nb_examples // batch_size
