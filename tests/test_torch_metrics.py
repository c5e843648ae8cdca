"""PyTorch port: the host-side metrics added for the rate-distortion
study (``rate_3d``, the Bjontegaard metric and its fit-quality flags,
``count_nb_deads``, ``mean_psnr``, ``count_zero_columns``) against the
JAX package's ``ops/metrics.py``. Both are numpy on the host, so the same
arrays must give the same numbers to the last bit, and the same errors.
"""

import warnings

import numpy
import pytest

from autoencoder_based_image_compression_tpu.ops import metrics as jmetrics
from autoencoder_based_image_compression_tpu_torch.ops import metrics

RATES_0 = numpy.array([0.12, 0.25, 0.48, 0.81, 1.20])
PSNRS_0 = numpy.array([27.1, 29.8, 32.6, 35.0, 37.2])
RATES_1 = numpy.array([0.10, 0.22, 0.41, 0.70, 1.05])
PSNRS_1 = numpy.array([27.5, 30.1, 32.9, 35.4, 37.9])


def _quantized_latent(seed, bin_widths):
    rng = numpy.random.default_rng(seed)
    data = (3.0 * rng.standard_normal((6, 9, bin_widths.size))).astype(numpy.float32)
    return bin_widths * numpy.round(data / bin_widths)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rate_3d_equals_jax(seed):
    bin_widths = numpy.random.default_rng(seed).uniform(0.5, 3.0, 16).astype(numpy.float32)
    latent = _quantized_latent(seed, bin_widths)
    got = metrics.rate_3d(latent, bin_widths, 96, 144)
    assert got == jmetrics.rate_3d(latent, bin_widths, 96, 144) and got > 0.0


@pytest.mark.parametrize("bad", ["ndim", "size"])
def test_rate_3d_raises_like_jax(bad):
    bin_widths = numpy.ones((2, 8) if bad == "ndim" else 7, numpy.float32)
    latent = numpy.zeros((4, 4, 8), numpy.float32)
    for module in (metrics, jmetrics):
        with pytest.raises(ValueError):
            module.rate_3d(latent, bin_widths, 64, 64)


def test_compute_bjontegaard_equals_jax_and_is_antisymmetric_in_sign():
    got = metrics.compute_bjontegaard(RATES_0, PSNRS_0, RATES_1, PSNRS_1)
    assert got == jmetrics.compute_bjontegaard(RATES_0, PSNRS_0, RATES_1, PSNRS_1)
    assert got < 0.0 < metrics.compute_bjontegaard(RATES_1, PSNRS_1, RATES_0, PSNRS_0)
    assert abs(metrics.compute_bjontegaard(RATES_0, PSNRS_0, RATES_0, PSNRS_0)) < 1e-9


@pytest.mark.parametrize("warn", [True, False])
def test_compute_bjontegaard_warns_on_a_sliver_overlap_like_jax(warn):
    psnrs_high = PSNRS_1 + 9.5  # 0.6 dB of overlap
    results = []
    for module in (metrics, jmetrics):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results.append(module.compute_bjontegaard(RATES_0, PSNRS_0, RATES_1, psnrs_high,
                                                      warn=warn))
        runtime = [w for w in caught if issubclass(w.category, RuntimeWarning)]
        assert len(runtime) == (1 if warn else 0)
        if warn:
            assert "untrustworthy" in str(runtime[0].message)
    assert results[0] == results[1]


@pytest.mark.parametrize("bad", ["ndim", "shape", "sign"])
def test_compute_bjontegaard_raises_like_jax(bad):
    (rates_0, psnrs_0) = (RATES_0, PSNRS_0)
    if bad == "ndim":
        (rates_0, psnrs_0) = (RATES_0[None], PSNRS_0[None])
    elif bad == "shape":
        psnrs_0 = PSNRS_0[:-1]
    else:
        rates_0 = RATES_0 * numpy.array([1.0, -1.0, 1.0, 1.0, 1.0])
    for module in (metrics, jmetrics):
        with pytest.raises((ValueError, AssertionError)):
            module.compute_bjontegaard(rates_0, psnrs_0, RATES_1, PSNRS_1)


@pytest.mark.parametrize("shift", [0.0, 9.5, 20.0])
def test_bjontegaard_fit_quality_equals_jax(shift):
    got = metrics.bjontegaard_fit_quality(RATES_0, PSNRS_0, RATES_1, PSNRS_1 + shift)
    assert got == jmetrics.bjontegaard_fit_quality(RATES_0, PSNRS_0, RATES_1, PSNRS_1 + shift)
    assert got["reliable"] is (shift == 0.0)
    assert got["narrow_overlap"] is (shift > 0.0)


def test_bjontegaard_fit_quality_flags_a_non_monotone_cubic():
    psnrs = numpy.array([27.0, 31.0, 30.0, 35.0, 37.0])
    got = metrics.bjontegaard_fit_quality(RATES_0, psnrs, RATES_1, PSNRS_1)
    assert got == jmetrics.bjontegaard_fit_quality(RATES_0, psnrs, RATES_1, PSNRS_1)


def test_count_nb_deads_equals_jax():
    rng = numpy.random.default_rng(3)
    array = rng.integers(-2, 3, size=(5, 4, 6, 16)).astype(numpy.float32)
    array[0, :, :, 3] = 0.0
    array[2, :, :, [1, 7, 9]] = 0.0
    got = metrics.count_nb_deads(array)
    numpy.testing.assert_array_equal(got, jmetrics.count_nb_deads(array))
    assert got[0] >= 1 and got[2] >= 3
    for module in (metrics, jmetrics):
        with pytest.raises(ValueError):
            module.count_nb_deads(array[0])


def test_mean_psnr_equals_jax_and_refuses_what_jax_refuses():
    rng = numpy.random.default_rng(4)
    reference = rng.integers(0, 256, size=(6, 48)).astype(numpy.uint8)
    reconstruction = numpy.clip(reference.astype(numpy.int32) + rng.integers(-9, 10, (6, 48)),
                                0, 255).astype(numpy.uint8)
    reconstruction[:, 0] = reference[:, 0] ^ 1  # no zero-MSE row
    assert metrics.mean_psnr(reference, reconstruction) == jmetrics.mean_psnr(reference,
                                                                              reconstruction)
    for module in (metrics, jmetrics):
        with pytest.raises(TypeError):
            module.mean_psnr(reference.astype(numpy.float32), reconstruction)
        with pytest.raises(TypeError):
            module.mean_psnr(reference, reconstruction.astype(numpy.int16))
        with pytest.raises(ValueError):
            module.mean_psnr(reference[0], reconstruction[0])
        with pytest.raises(ValueError):
            module.mean_psnr(reference, reconstruction[:, :-1])
        with pytest.raises(ValueError):
            module.mean_psnr(reference, reference)


def test_count_zero_columns_equals_jax():
    array = numpy.array([[0.0, 1.0, 0.0, -2.0], [0.0, 0.0, 0.0, 3.0]])
    assert metrics.count_zero_columns(array) == jmetrics.count_zero_columns(array) == 2
    for module in (metrics, jmetrics):
        with pytest.raises(ValueError):
            module.count_zero_columns(array[0])
