"""Host-side rate/distortion metrics (numpy, like the reference's
``tools/tools.py``): symbol histograms, discrete entropy, PSNR, the
training monitors and the Jensen-Shannon divergence."""

import numpy


def count_symbols(quantized_samples, bin_width):
    """Histogram of the quantized samples over the symbol alphabet.

    Symbols are spaced ``bin_width`` apart from the smallest to the
    largest quantized sample (reference ``tools/tools.py:322-388``,
    including the quantization-omission assertion).
    """
    if bin_width <= 0.0:
        raise ValueError("The quantization bin width is not strictly positive.")
    quantized_samples = numpy.asarray(quantized_samples)
    numpy.testing.assert_almost_equal(
        bin_width * numpy.round(quantized_samples / bin_width),
        quantized_samples,
        decimal=10,
        err_msg="The quantization was omitted.",
    )
    minimum = numpy.amin(quantized_samples)
    maximum = numpy.amax(quantized_samples)
    nb_edges = int(numpy.round((maximum - minimum) / bin_width)) + 2
    bin_edges = numpy.linspace(minimum - 0.5 * bin_width,
                               maximum + 0.5 * bin_width,
                               num=nb_edges)
    return numpy.histogram(quantized_samples, bins=bin_edges)[0]


def discrete_entropy(quantized_samples, bin_width):
    """Empirical entropy (bits/symbol) of the quantized samples.

    Reference ``tools/tools.py:486-537`` with its bounds checks.
    """
    hist = count_symbols(quantized_samples, bin_width)
    hist_non_zero = numpy.extract(hist != 0, hist)
    frequency = hist_non_zero.astype(numpy.float64) / numpy.sum(hist_non_zero)
    disc_entropy = -numpy.sum(frequency * numpy.log2(frequency))
    if disc_entropy < 0.0:
        raise ValueError("The entropy is not positive.")
    if disc_entropy > numpy.log2(hist_non_zero.size):
        raise ValueError("The entropy is not smaller than its upper bound.")
    return disc_entropy


def average_entropies(data, bin_widths):
    """Quantises per map and averages the per-map discrete entropies.

    Training monitor (reference ``tools/tools.py:25-59``).
    """
    data = numpy.asarray(data)
    bin_widths = numpy.asarray(bin_widths)
    quantized = bin_widths * numpy.round(data / bin_widths)
    nb_maps = data.shape[-1]
    cumulated = 0.0
    for i in range(nb_maps):
        cumulated += discrete_entropy(quantized[..., i], bin_widths[i].item())
    return cumulated / nb_maps


def convert_approx_entropy(scaled_approx_entropy, gamma_scaling, nb_maps):
    """Mean form of the scaled cumulated approximate entropy
    (reference ``tools/tools.py:265-292``)."""
    return scaled_approx_entropy / (gamma_scaling * nb_maps)


def jensen_shannon_divergence(probs_0, probs_1):
    """Jensen-Shannon divergence between two discrete distributions.

    Reference ``tools/tools.py:615-666`` with its validity checks; used
    to pick the near-uniform exception map in the coding statistics.
    """
    probs_0 = numpy.asarray(probs_0, dtype=numpy.float64)
    probs_1 = numpy.asarray(probs_1, dtype=numpy.float64)
    for (name, probs) in (("probs_0", probs_0), ("probs_1", probs_1)):
        if numpy.any(probs <= 0.0) or numpy.any(probs >= 1.0):
            raise ValueError(f"A probability in `{name}` does not belong to ]0., 1.[.")
        if abs(numpy.sum(probs).item() - 1.0) >= 1.0e-9:
            raise ValueError(f"The probabilities in `{name}` do not sum to 1.0.")
    denominator = 0.5 * (probs_0 + probs_1)
    divergence = 0.5 * numpy.sum(
        probs_0 * numpy.log2(probs_0 / denominator)
        + probs_1 * numpy.log2(probs_1 / denominator)
    )
    if divergence < 0.0 or divergence > 1.0:
        raise ValueError("The Jensen-Shannon divergence is out of [0., 1.].")
    return divergence


def psnr_2d(reference_uint8, reconstruction_uint8):
    """PSNR in dB between a uint8 luminance image and its reconstruction.

    Reference ``tools/tools.py:831-881``.
    """
    if reference_uint8.dtype != numpy.uint8:
        raise TypeError("`reference_uint8.dtype` is not equal to `numpy.uint8`.")
    if reconstruction_uint8.dtype != numpy.uint8:
        raise TypeError("`reconstruction_uint8.dtype` is not equal to `numpy.uint8`.")
    if reference_uint8.ndim != 2:
        raise ValueError("`reference_uint8.ndim` is not equal to 2.")
    if reference_uint8.shape != reconstruction_uint8.shape:
        raise ValueError("shape mismatch between reference and reconstruction.")
    mse = numpy.mean(
        (reference_uint8.astype(numpy.float64) - reconstruction_uint8.astype(numpy.float64)) ** 2
    )
    if mse == 0.0:
        raise ValueError("The mean squared error is 0.")
    return 10.0 * numpy.log10((255.0 ** 2) / mse)
