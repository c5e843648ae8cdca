"""Coding statistics collected on a held-out set (numpy only).

Counterpart of ``kodak_tensorflow/lossless/stats.py``: the encoder-side
"model" of the arithmetic coder - per-map means, the near-uniform
exception map (Jensen-Shannon distance to uniform), and per-(map,
multiplier) truncated-unary binary probabilities - is computed on the
held-out "extra" set so the statistics cost no bits at test time
(``collecting_stats_eae_extra.py:4-7``). Must be regenerated whenever
the model is retrained.
"""

import os
import pickle

import numpy

from autoencoder_based_image_compression_tpu_torch.ops import metrics


def count_binary_decisions(abs_centered_quantized_data, bin_width_test,
                           truncated_unary_length):
    """Occurrences of 0/1 per truncated-unary binary decision.

    Computed from the symbol histogram instead of materializing the
    unary codes (reference ``stats.py:136-195``).
    """
    abs_data = numpy.asarray(abs_centered_quantized_data)
    if numpy.any(abs_data < 0.0):
        raise ValueError("An element of `abs_centered_quantized_data` is not positive.")
    hist = metrics.count_symbols(abs_data, bin_width_test)
    cumulated_zeros = numpy.zeros(truncated_unary_length, dtype=numpy.int64)
    cumulated_ones = numpy.zeros(truncated_unary_length, dtype=numpy.int64)
    minimum = int(round(numpy.amin(abs_data).item() / bin_width_test))
    for i in range(hist.size):
        ii = i + minimum
        if ii < truncated_unary_length:
            cumulated_ones[0:ii] += hist[i]
            cumulated_zeros[ii] += hist[i]
        else:
            cumulated_ones += hist[i]
    return (cumulated_zeros, cumulated_ones)


def compute_binary_probabilities(y_float32, bin_widths_test, map_mean,
                                 truncated_unary_length):
    """Per-map truncated-unary zero-probabilities at one bin-width sweep.

    nan -> 0.5 for never-seen decisions, clamped into [0.01, 0.99]
    (reference ``stats.py:13-68``).
    """
    (nb_images, height_map, width_map, nb_maps) = y_float32.shape
    centered = y_float32 - map_mean.reshape(1, 1, 1, nb_maps)
    bin_widths_test = numpy.asarray(bin_widths_test, dtype=y_float32.dtype)
    centered_quantized = bin_widths_test * numpy.round(centered / bin_widths_test)
    cumulated_zeros = numpy.zeros((nb_maps, truncated_unary_length), dtype=numpy.int64)
    cumulated_ones = numpy.zeros((nb_maps, truncated_unary_length), dtype=numpy.int64)
    for i in range(nb_maps):
        (cumulated_zeros[i], cumulated_ones[i]) = count_binary_decisions(
            numpy.absolute(centered_quantized[:, :, :, i]),
            float(bin_widths_test[i]),
            truncated_unary_length)
    total = cumulated_zeros + cumulated_ones
    with numpy.errstate(invalid="ignore"):
        probabilities = cumulated_zeros.astype(numpy.float64) / total.astype(numpy.float64)
    probabilities[numpy.isnan(probabilities)] = 0.5
    probabilities[probabilities == 0.0] = 0.01
    probabilities[probabilities == 1.0] = 0.99
    return probabilities


def compute_probabilities_intervals(data, size_interval):
    """Probability mass of each unit axis interval of the data range.

    Reference ``stats.py:70-134``.
    """
    data = numpy.asarray(data)
    edge_left = numpy.floor(numpy.amin(data)).item()
    edge_right = numpy.ceil(numpy.amax(data)).item()
    difference_edges = edge_right - edge_left
    if difference_edges < size_interval:
        raise ValueError("The interval size exceeds the range of the data values.")
    nb_edges_minus_1 = difference_edges / size_interval
    if not float(nb_edges_minus_1).is_integer():
        raise ValueError("The data range is not an integer number of intervals.")
    bin_edges = numpy.linspace(edge_left, edge_right, num=int(nb_edges_minus_1) + 1)
    hist = numpy.histogram(data, bins=bin_edges, density=True)[0]
    return (bin_edges, hist * size_interval)


def find_index_map_exception(y_float32):
    """Index of the latent map closest to uniform (JS divergence).

    That map is costed by its entropy estimate instead of being
    arithmetic-coded (reference ``stats.py:197-241``).
    """
    divergences = numpy.zeros(y_float32.shape[3])
    for i in range(y_float32.shape[3]):
        probs = compute_probabilities_intervals(y_float32[:, :, :, i], 1.0)[1]
        probs_non_zero = numpy.extract(probs != 0.0, probs)
        if probs_non_zero.size > 1:
            uniform = numpy.full(probs_non_zero.size, 1.0 / probs_non_zero.size)
            divergences[i] = metrics.jensen_shannon_divergence(probs_non_zero, uniform)
        else:
            divergences[i] = 1.0
    return int(numpy.argmin(divergences))


def save_statistics(y_float32, bin_widths, multipliers, truncated_unary_length,
                    path_to_map_mean, path_to_idx_map_exception,
                    paths_to_binary_probabilities):
    """Persists map means, the exception index and probability tables.

    ``y_float32`` are the latents of the held-out set; encoding them is
    the caller's concern, so this layer knows nothing of the model.
    Existing files are left alone (reference ``stats.py:294-297``).
    """
    multipliers = numpy.asarray(multipliers, dtype=numpy.float32)
    if len(paths_to_binary_probabilities) != multipliers.size:
        raise ValueError(
            "`len(paths_to_binary_probabilities)` != `multipliers.size`.")
    existing = [os.path.isfile(p) for p in paths_to_binary_probabilities]
    if (os.path.isfile(path_to_map_mean) and os.path.isfile(path_to_idx_map_exception)
            and all(existing)):
        print("The statistics on the latent variable feature maps already exist.")
        print("Delete them manually to recompute them.")
        return
    map_mean = numpy.mean(y_float32, axis=(0, 1, 2))
    numpy.save(path_to_map_mean, map_mean)
    idx_map_exception = find_index_map_exception(y_float32)
    with open(path_to_idx_map_exception, "wb") as file:
        pickle.dump(idx_map_exception, file)
    for (i, multiplier) in enumerate(multipliers):
        bin_widths_test = multiplier * numpy.asarray(bin_widths, dtype=numpy.float32)
        probabilities = compute_binary_probabilities(
            y_float32, bin_widths_test, map_mean, truncated_unary_length)
        numpy.save(paths_to_binary_probabilities[i], probabilities)
