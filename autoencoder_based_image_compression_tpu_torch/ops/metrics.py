"""Host-side rate/distortion metrics (numpy, like the reference's
``tools/tools.py``): symbol histograms, discrete entropy, theoretical
rate, PSNR, the Bjontegaard metric with its fit-quality flags, dead-map
counting, the training monitors and the Jensen-Shannon divergence."""

import warnings

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


def rate_3d(quantized_latent, bin_widths, h_in, w_in):
    """Theoretical (entropy-coded) rate in bits per input pixel.

    ``sum_i H_map*W_map*entropy(map_i) / (h_in*w_in)`` over the latent
    maps of one image (reference ``tools/tools.py:931-988``). This is
    the non-coded rate; the true rate comes from the arithmetic coder.
    """
    quantized_latent = numpy.asarray(quantized_latent)
    bin_widths = numpy.asarray(bin_widths)
    if bin_widths.ndim != 1:
        raise ValueError("`bin_widths.ndim` is not equal to 1.")
    (height_map, width_map, nb_maps) = quantized_latent.shape
    if bin_widths.size != nb_maps:
        raise ValueError("`bin_widths.size` != `quantized_latent.shape[2]`.")
    cumulated_rate = 0.0
    for i in range(nb_maps):
        disc_entropy = discrete_entropy(quantized_latent[:, :, i], bin_widths[i].item())
        cumulated_rate += disc_entropy * height_map * width_map
    return cumulated_rate / (h_in * w_in)


def bjontegaard_fit_quality(rates_0, psnrs_0, rates_1, psnrs_1,
                            min_overlap_db=1.5):
    """Diagnostics of the cubic Bjontegaard fit's trustworthiness.

    The cubic polyfit in (PSNR, ln rate) amplifies checkpoint noise
    when the curves barely overlap or a fitted cubic is non-monotone on
    the overlap (a rate-distortion curve's ln-rate must increase with
    PSNR).
    Returns a dict: ``overlap_db`` (PSNR overlap of the two curves),
    ``narrow_overlap`` (overlap < ``min_overlap_db``), ``monotone_0`` /
    ``monotone_1`` (each cubic's slope positive across the overlap) and
    ``reliable`` (all good). Reference fit: ``tools/tools.py:157-263``.
    """
    rates_0 = numpy.asarray(rates_0, dtype=numpy.float64)
    rates_1 = numpy.asarray(rates_1, dtype=numpy.float64)
    psnrs_0 = numpy.asarray(psnrs_0, dtype=numpy.float64)
    psnrs_1 = numpy.asarray(psnrs_1, dtype=numpy.float64)
    minimum = max(numpy.amin(psnrs_0).item(), numpy.amin(psnrs_1).item())
    maximum = min(numpy.amax(psnrs_0).item(), numpy.amax(psnrs_1).item())
    overlap_db = maximum - minimum
    quality = {
        "overlap_db": overlap_db,
        "narrow_overlap": bool(overlap_db < min_overlap_db),
        "monotone_0": True,
        "monotone_1": True,
    }
    if overlap_db > 0.0:
        grid = numpy.linspace(minimum, maximum, 64)
        for (idx, (psnrs, rates)) in enumerate(
                ((psnrs_0, rates_0), (psnrs_1, rates_1))):
            coeffs = numpy.polyfit(psnrs, numpy.log(rates), 3)
            slope = numpy.polyval(numpy.polyder(coeffs), grid)
            quality[f"monotone_{idx}"] = bool(numpy.all(slope > 0.0))
    quality["reliable"] = bool(not quality["narrow_overlap"]
                               and quality["monotone_0"]
                               and quality["monotone_1"])
    return quality


def compute_bjontegaard(rates_0, psnrs_0, rates_1, psnrs_1, warn=True):
    """Bjontegaard average %-bitrate saving of curve 1 over curve 0.

    Cubic polynomial fit in (PSNR, ln rate), integrated over the
    overlapping PSNR range (reference ``tools/tools.py:157-263``).
    With ``warn=True`` a RuntimeWarning is emitted when
    :func:`bjontegaard_fit_quality` finds the fit untrustworthy (sliver
    overlap or a non-monotone cubic) so the number cannot circulate
    without its caveat.
    """
    rates_0 = numpy.asarray(rates_0, dtype=numpy.float64)
    rates_1 = numpy.asarray(rates_1, dtype=numpy.float64)
    psnrs_0 = numpy.asarray(psnrs_0, dtype=numpy.float64)
    psnrs_1 = numpy.asarray(psnrs_1, dtype=numpy.float64)
    if rates_0.ndim != 1 or rates_1.ndim != 1:
        raise ValueError("rates must be 1D arrays.")
    if psnrs_0.shape != rates_0.shape or psnrs_1.shape != rates_1.shape:
        raise ValueError("psnrs shape must match rates shape.")
    for name, arr in (("rates_0", rates_0), ("rates_1", rates_1),
                      ("psnrs_0", psnrs_0), ("psnrs_1", psnrs_1)):
        numpy.testing.assert_array_less(
            0.0, arr, err_msg=f"An element of `{name}` is not strictly positive.")
    if warn:
        quality = bjontegaard_fit_quality(rates_0, psnrs_0, rates_1, psnrs_1)
        if not quality["reliable"]:
            warnings.warn(
                "The Bjontegaard cubic fit looks untrustworthy: "
                f"overlap {quality['overlap_db']:.2f} dB"
                f"{' (narrow)' if quality['narrow_overlap'] else ''}, "
                f"monotone curves ({quality['monotone_0']}, "
                f"{quality['monotone_1']}). Treat the returned saving as "
                "indicative only.", RuntimeWarning, stacklevel=2)
    coeffs_0 = numpy.polyfit(psnrs_0, numpy.log(rates_0), 3)
    coeffs_1 = numpy.polyfit(psnrs_1, numpy.log(rates_1), 3)
    minimum = max(numpy.amin(psnrs_0).item(), numpy.amin(psnrs_1).item())
    maximum = min(numpy.amax(psnrs_0).item(), numpy.amax(psnrs_1).item())
    anti_0 = numpy.polyint(coeffs_0)
    anti_1 = numpy.polyint(coeffs_1)
    integral_0 = numpy.polyval(anti_0, maximum) - numpy.polyval(anti_0, minimum)
    integral_1 = numpy.polyval(anti_1, maximum) - numpy.polyval(anti_1, minimum)
    return 100.0 * (numpy.exp((integral_1 - integral_0) / (maximum - minimum)).item() - 1.0)


def count_nb_deads(array_4d):
    """Number of all-zero feature maps per example of a NHWC array.

    Reference ``tools/tools.py:294-320``.
    """
    array_4d = numpy.asarray(array_4d)
    if array_4d.ndim != 4:
        raise ValueError("`array_4d.ndim` is not equal to 4.")
    sum_absolute = numpy.sum(numpy.absolute(array_4d), axis=(1, 2))
    return numpy.sum(sum_absolute == 0, axis=1)


def mean_psnr(reference_uint8, reconstruction_uint8):
    """Mean PSNR over a batch of flattened uint8 images (rows).

    Reference ``svhn/tools/tools.py:812-865``, including its refusal of
    a zero-MSE pair (a perfect reconstruction is impossible in lossy
    compression, so it indicates a pipeline bug).
    """
    if reference_uint8.dtype != numpy.uint8:
        raise TypeError("`reference_uint8.dtype` is not equal to `numpy.uint8`.")
    if reconstruction_uint8.dtype != numpy.uint8:
        raise TypeError("`reconstruction_uint8.dtype` is not equal to `numpy.uint8`.")
    if reference_uint8.ndim != 2:
        raise ValueError("`reference_uint8.ndim` is not equal to 2.")
    if reference_uint8.shape != reconstruction_uint8.shape:
        raise ValueError(
            "`reference_uint8.shape` is not equal to `reconstruction_uint8.shape`.")
    mse = numpy.mean(
        (reference_uint8.astype(numpy.float64)
         - reconstruction_uint8.astype(numpy.float64)) ** 2, axis=1)
    if numpy.any(mse == 0.0):
        raise ValueError("The mean square error between a reference image and "
                         "its reconstruction is equal to 0.")
    return numpy.mean(10.0 * numpy.log10((255.0 ** 2) / mse))


def count_zero_columns(array_2d):
    """Number of all-zero columns - the dense-side dead-latent counter
    (reference ``svhn/tools/tools.py:232-254``; the conv-side analog is
    :func:`count_nb_deads`)."""
    array_2d = numpy.asarray(array_2d)
    if array_2d.ndim != 2:
        raise ValueError("`array_2d.ndim` is not equal to 2.")
    return array_2d.shape[1] - int(
        numpy.count_nonzero(numpy.sum(numpy.absolute(array_2d), axis=0)))
