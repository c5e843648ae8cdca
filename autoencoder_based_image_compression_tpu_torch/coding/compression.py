"""Map-level lossless compression API.

Each of the 128 latent maps is coded independently by the C++ coder;
the near-uniform "exception" map is costed by its entropy estimate,
``ceil(H*W*entropy)``, instead of being arithmetic-coded (reference
``lossless/compression.py:68-75``); with ``verify`` the reconstruction
is asserted bit-exact.
"""

import numpy

from autoencoder_based_image_compression_tpu_torch.coding import native
from autoencoder_based_image_compression_tpu_torch.ops.metrics import discrete_entropy


def _load_probabilities(binary_probabilities):
    if isinstance(binary_probabilities, str):
        binary_probabilities = numpy.load(binary_probabilities)
    if binary_probabilities.ndim != 2:
        raise ValueError("`binary_probabilities.ndim` is not equal to 2.")
    return binary_probabilities


def compress_lossless_maps(ref_int16, binary_probabilities, idx_map_exception=-1,
                           nb_threads=0):
    """Compresses each int16 map of one image separately.

    ``ref_int16`` is ``(height_map, width_map, nb_maps)`` int16;
    ``binary_probabilities`` is ``(nb_maps, tu_len)`` or a path to an
    ``.npy`` holding it; ``idx_map_exception`` -1 disables the exception
    map. Returns ``(reconstruction int16 of the same shape, per-map bit
    costs uint32)``.
    """
    if ref_int16.dtype != numpy.int16:
        raise TypeError("`ref_int16.dtype` is not equal to `numpy.int16`.")
    binary_probabilities = _load_probabilities(binary_probabilities)
    (height_map, width_map, nb_maps) = ref_int16.shape
    if binary_probabilities.shape[0] != nb_maps:
        raise ValueError("`binary_probabilities.shape[0]` != `ref_int16.shape[2]`.")

    # Maps-first layout for the batch coder.
    symbols = numpy.ascontiguousarray(
        numpy.moveaxis(ref_int16, 2, 0).reshape(nb_maps, height_map * width_map))
    coded_rows = [i for i in range(nb_maps) if i != idx_map_exception]
    rec_int16 = numpy.zeros_like(ref_int16)
    nb_bits_each_map = numpy.zeros(nb_maps, dtype=numpy.uint32)

    if coded_rows:
        (rec_rows, bits_rows) = native.compress_lossless_batch(
            symbols[coded_rows], binary_probabilities[coded_rows], nb_threads)
        rec_int16[:, :, coded_rows] = numpy.moveaxis(
            rec_rows.reshape(len(coded_rows), height_map, width_map), 0, 2)
        nb_bits_each_map[coded_rows] = bits_rows

    if 0 <= idx_map_exception < nb_maps:
        cumulated_entropy = height_map * width_map * discrete_entropy(
            ref_int16[:, :, idx_map_exception].astype(numpy.float32), 1.0)
        nb_bits_each_map[idx_map_exception] = numpy.ceil(cumulated_entropy).astype(numpy.uint32)
        rec_int16[:, :, idx_map_exception] = ref_int16[:, :, idx_map_exception]
    return (rec_int16, nb_bits_each_map)


def compress_lossless_images(symbols_int16, binary_probabilities,
                             idx_map_exception=-1, nb_threads=0, verify=True):
    """Codes a whole image batch's maps in ONE C++ thread-pool call.

    ``symbols_int16`` is ``(nb_images, height_map, width_map, nb_maps)``
    int16. ``verify=True`` round-trips and asserts every map
    bit-exactly; ``verify=False`` encodes only (same bit counts).

    Returns ``nb_bits_per_image`` (int64, shape ``(nb_images,)``); the
    exception map of every image is costed by its entropy estimate.
    """
    if symbols_int16.dtype != numpy.int16:
        raise TypeError("`symbols_int16.dtype` is not equal to `numpy.int16`.")
    if symbols_int16.ndim != 4:
        raise ValueError("`symbols_int16.ndim` is not equal to 4.")
    binary_probabilities = _load_probabilities(binary_probabilities)
    (nb_images, height_map, width_map, nb_maps) = symbols_int16.shape
    if binary_probabilities.shape[0] != nb_maps:
        raise ValueError("`binary_probabilities.shape[0]` != `symbols_int16.shape[3]`.")
    coded_maps = [m for m in range(nb_maps) if m != idx_map_exception]

    # (images, maps, h*w) rows, maps-major within each image, C-contiguous:
    # the coder reads raw pointers.
    rows = numpy.ascontiguousarray(
        numpy.moveaxis(symbols_int16, 3, 1)[:, coded_maps].reshape(
            nb_images * len(coded_maps), height_map * width_map))
    probs = numpy.broadcast_to(
        binary_probabilities[coded_maps][None],
        (nb_images, len(coded_maps), binary_probabilities.shape[1]))
    probs = numpy.ascontiguousarray(
        probs.reshape(nb_images * len(coded_maps), -1))
    (rec_rows, bits_rows) = native.compress_lossless_batch(
        rows, probs, nb_threads, verify=verify)
    if verify:
        numpy.testing.assert_equal(
            rec_rows, rows,
            err_msg="The lossless compression has altered the symbols.")
    nb_bits = bits_rows.reshape(nb_images, len(coded_maps)).sum(
        axis=1, dtype=numpy.int64)

    if 0 <= idx_map_exception < nb_maps:
        for i in range(nb_images):
            cumulated_entropy = height_map * width_map * discrete_entropy(
                symbols_int16[i, :, :, idx_map_exception].astype(numpy.float32),
                1.0)
            nb_bits[i] += int(numpy.ceil(cumulated_entropy))
    return nb_bits
