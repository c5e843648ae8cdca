"""PyTorch port: the rate-distortion sweep (``eval/rd_sweep.py``) against
the JAX package's on the same images and models, on the CPU, and against
the curves committed under ``results/eae/kodak_rd/``.

The two packages' float32 transforms differ in the last bits (measured
in ``tests/test_torch_transforms.py``), so a latent that sits on a
rounding boundary may quantise to the neighbouring symbol. Where no
symbol flips the rates are equal; the tests state the flip count
(measured: 0 on these inputs) and hold the PSNR to 0.01 dB.

Against the committed curves (made by the JAX package on the
24 images of ``synthetic_kodak(seed=14)``): the port on the CPU, the
first two images, the trained gamma 10,000 and 96,000 models: rates
within 1e-4 bpp (measured 3.8e-6), PSNR within 0.001 dB (measured
1.1e-4).
"""

import hashlib
import os
import pickle

import jax
import numpy
import pytest

from autoencoder_based_image_compression_tpu.coding import compression as jcompression
from autoencoder_based_image_compression_tpu.eval import rd_sweep as jrd_sweep
from autoencoder_based_image_compression_tpu.models import conv_eae as jconv_eae
from autoencoder_based_image_compression_tpu.train import loop as jloop
from autoencoder_based_image_compression_tpu_torch.coding import compression, native
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_kodak,
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.eval import rd_sweep
from autoencoder_based_image_compression_tpu_torch.train import loop
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results", "eae")
LEARNED = os.path.join(RESULTS, "learning_bw", "0dot5_10000")
VARY_ID = ("g10000s88307-12000s88307-16000s88307-24000s88307-40000s88307-72000s88307-"
           "96000s88074")
MULTIPLIERS = [1.0, 4.0]
PSNR_TOL_DB = 0.01


def _random_model(seed, learn_bin_widths):
    """Freshly initialised parameters in both packages' layouts."""
    params = jconv_eae.init_conv_eae_params(jax.random.PRNGKey(seed), learn_bin_widths)
    params_np = {name: numpy.asarray(value) for (name, value) in params.items()}
    return (params, params_from_jax(params_np))


def _trained_learned():
    (params_np, bin_widths) = load_params_artifact(os.path.join(LEARNED, "params_trained.npz"))
    stats = os.path.join(LEARNED, "statistics")
    with open(os.path.join(stats, "idx_map_exception.pkl"), "rb") as file:
        idx_exception = pickle.load(file)
    probabilities = [numpy.load(os.path.join(stats, f"binary_probabilities_{name}.npy"))
                     for name in ("1", "4")]
    return (params_np, params_from_jax(params_np), bin_widths,
            numpy.load(os.path.join(stats, "map_mean.npy")), probabilities, idx_exception)


def _images(nb_images, seed):
    return synthetic_luminance_stack(nb_images, 64, 96, seed)[..., 0]


def _symbol_flips(images, jax_params, torch_params, learn_bin_widths, bin_widths, map_mean):
    batch = images[..., None]
    y_jax = jloop.encode_mini_batches(batch, jax_params, learn_bin_widths, 2)
    y_torch = loop.encode_mini_batches(batch, torch_params, learn_bin_widths, 2)
    mean = 0.0 if map_mean is None else map_mean
    flips = numpy.round((y_jax - mean) / bin_widths) != numpy.round((y_torch - mean) / bin_widths)
    return int(numpy.count_nonzero(flips))


def _assert_points_agree(got, expected, flips):
    (rates, psnrs, reconstructions, nb_deads) = got
    (rates_j, psnrs_j, reconstructions_j, nb_deads_j) = expected
    assert rates.shape == rates_j.shape and reconstructions.dtype == numpy.uint8
    assert numpy.abs(psnrs - psnrs_j).max() <= PSNR_TOL_DB
    if flips == 0:
        numpy.testing.assert_array_equal(rates, rates_j)
        numpy.testing.assert_array_equal(nb_deads, numpy.asarray(nb_deads_j))
    else:
        numpy.testing.assert_allclose(rates, rates_j, rtol=0.01)
    assert numpy.mean(reconstructions != reconstructions_j) < 1e-2


@pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
def test_compute_rate_psnr_entropy_rate_matches_jax(learn_bin_widths):
    (jax_params, torch_params) = _random_model(0, learn_bin_widths)
    images = _images(4, 0)
    bin_widths = numpy.full(128, 2.0, numpy.float32)
    flips = _symbol_flips(images, jax_params, torch_params, learn_bin_widths, bin_widths, None)
    print(f"symbol flips: {flips}")
    _assert_points_agree(
        rd_sweep.compute_rate_psnr(images, torch_params, bin_widths, learn_bin_widths, 2),
        jrd_sweep.compute_rate_psnr(images, jax_params, bin_widths, learn_bin_widths, 2), flips)


@pytest.mark.parametrize("centred", [True, False], ids=["map_mean", "no_mean"])
@pytest.mark.parametrize("coded", [True, False], ids=["coded", "entropy"])
def test_compute_rate_psnr_on_the_trained_model_matches_jax(coded, centred):
    (params_np, torch_params, bin_widths, map_mean, probabilities, idx_exception) = \
        _trained_learned()
    images = _images(2, 1)
    mean = map_mean if centred else None
    kwargs = dict(map_mean=mean, binary_probabilities=probabilities[0] if coded else None,
                  idx_map_exception=idx_exception if coded else -1)
    flips = _symbol_flips(images, params_np, torch_params, True, bin_widths, mean)
    print(f"symbol flips: {flips}")
    got = rd_sweep.compute_rate_psnr(images, torch_params, bin_widths, True, 2, **kwargs)
    _assert_points_agree(
        got, jrd_sweep.compute_rate_psnr(images, params_np, bin_widths, True, 2, **kwargs), flips)
    assert numpy.all(got[0] > 0.0) and numpy.all(got[1] > 20.0)


def test_rescale_compress_lossless_maps_bit_counts_equal_jax():
    (_, _, bin_widths, _, probabilities, idx_exception) = _trained_learned()
    rng = numpy.random.default_rng(2)
    symbols = numpy.clip(numpy.round(rng.laplace(0.0, 1.5, (4, 6, 128))), -40, 40)
    for (multiplier, probs) in zip(MULTIPLIERS, probabilities):
        bw = (numpy.float32(multiplier) * bin_widths).astype(numpy.float32)
        data = symbols.astype(numpy.float32) * bw
        got = compression.rescale_compress_lossless_maps(data, bw, probs, idx_exception)
        assert got == jcompression.rescale_compress_lossless_maps(data, bw, probs,
                                                                 idx_exception)
        assert got > 0
    for module in (compression, jcompression):
        with pytest.raises(ValueError):
            module.rescale_compress_lossless_maps(data, bw[:-1], probs)
        with pytest.raises(ValueError):
            module.rescale_compress_lossless_maps(data, bw.reshape(1, -1), probs)


def test_compress_lossless_flattened_map_round_trips_and_checks_its_input():
    rng = numpy.random.default_rng(3)
    ref = numpy.clip(numpy.round(rng.laplace(0.0, 2.0, 600)), -30, 30).astype(numpy.int16)
    probabilities = numpy.linspace(0.3, 0.7, 10)
    (rec, nb_bits) = native.compress_lossless_flattened_map(ref, probabilities)
    numpy.testing.assert_array_equal(rec, ref)
    (_, bits_batch) = native.compress_lossless_batch(ref[None], probabilities[None])
    assert nb_bits == int(bits_batch[0]) > 0
    with pytest.raises(TypeError):
        native.compress_lossless_flattened_map(ref.astype(numpy.int32), probabilities)
    with pytest.raises(ValueError):
        native.compress_lossless_flattened_map(ref.reshape(2, -1), probabilities)
    with pytest.raises(ValueError):
        native.compress_lossless_flattened_map(ref, numpy.full(256, 0.5))


def test_sweeps_match_jax_and_write_the_same_cache_files(tmp_path):
    (params_np, torch_params, bin_widths, map_mean, probabilities, idx_exception) = \
        _trained_learned()
    (jax_fixed, torch_fixed) = _random_model(1, False)
    images = _images(2, 4)
    (dir_t, dir_j) = (str(tmp_path / "port"), str(tmp_path / "jax"))
    got = rd_sweep.fix_gamma(images, torch_params, bin_widths, True, MULTIPLIERS, 2, dir_t,
                             map_mean, probabilities, idx_exception, experiment_id="id_s1_coded")
    expected = jrd_sweep.fix_gamma(images, params_np, bin_widths, True, MULTIPLIERS, 2, dir_j,
                                   map_mean, probabilities, idx_exception,
                                   experiment_id="id_s1_coded")
    for (array, array_j) in zip(got, expected):
        assert array.shape == (2, 2) and array.dtype == array_j.dtype
    assert numpy.abs(got[1] - expected[1]).max() <= PSNR_TOL_DB
    numpy.testing.assert_allclose(got[0], expected[0], rtol=0.01)
    numpy.testing.assert_array_equal(got[2], expected[2])
    assert numpy.all(got[0][1] < got[0][0])  # coarser bins, lower rate

    gammas = [10000.0, 96000.0]
    got_v = rd_sweep.vary_gamma_fix_bin_widths(
        images, {g: torch_fixed for g in gammas}, gammas, 2, dir_t, experiment_id="g1-g2")
    expected_v = jrd_sweep.vary_gamma_fix_bin_widths(
        images, {g: jax_fixed for g in gammas}, gammas, 2, dir_j, experiment_id="g1-g2")
    assert got_v[0].shape == (2, 2)
    assert numpy.abs(got_v[1] - expected_v[1]).max() <= PSNR_TOL_DB
    numpy.testing.assert_allclose(got_v[0], expected_v[0], rtol=0.01)
    # Same file names: either package reads the other's cache directory.
    assert sorted(os.listdir(dir_t)) == sorted(os.listdir(dir_j)) == [
        "deads_fix_gamma_learn_id_s1_coded.npy", "psnrs_fix_gamma_learn_id_s1_coded.npy",
        "psnrs_vary_gamma_g1-g2.npy", "rates_fix_gamma_learn_id_s1_coded.npy",
        "rates_vary_gamma_g1-g2.npy"]
    from_jax_cache = rd_sweep.fix_gamma(images, None, bin_widths, True, MULTIPLIERS, 2, dir_j,
                                        experiment_id="id_s1_coded")
    for (array, array_j) in zip(from_jax_cache, expected):
        numpy.testing.assert_array_equal(array, array_j)


def test_cache_hit_and_stale_cache_guard(tmp_path):
    (_, torch_params) = _random_model(2, True)
    images = _images(2, 5)
    bin_widths = numpy.ones(128, numpy.float32)
    first = rd_sweep.fix_gamma(images, torch_params, bin_widths, True, MULTIPLIERS, 2,
                               str(tmp_path), experiment_id="0dot5_10000_s100")
    mutated = dict(torch_params)
    mutated["weights_1"] = 0.0 * mutated["weights_1"]
    # Same identity: from the cache, whatever the parameters.
    again = rd_sweep.fix_gamma(images, mutated, bin_widths, True, MULTIPLIERS, 2,
                               str(tmp_path), experiment_id="0dot5_10000_s100")
    for (a, b) in zip(first, again):
        numpy.testing.assert_array_equal(a, b)
    # Another identity misses the cache.
    other = rd_sweep.fix_gamma(images, mutated, bin_widths, True, MULTIPLIERS, 2,
                               str(tmp_path), experiment_id="0dot5_10000_s200")
    assert not numpy.array_equal(first[0], other[0])
    (_, fixed_params) = _random_model(3, False)
    first_v = rd_sweep.vary_gamma_fix_bin_widths(images, {1.0: fixed_params}, [1.0], 2,
                                                 str(tmp_path))
    again_v = rd_sweep.vary_gamma_fix_bin_widths(images, {1.0: None}, [1.0], 2,
                                                 str(tmp_path))
    numpy.testing.assert_array_equal(first_v[0], again_v[0])


def test_bjontegaard_summary_and_plot(tmp_path):
    rates = numpy.tile(numpy.array([[0.1], [0.3], [0.6], [1.0]]), (1, 3))
    psnrs = numpy.tile(numpy.array([[28.0], [31.0], [34.0], [37.0]]), (1, 3))
    path = str(tmp_path / "bd.pkl")
    delta = rd_sweep.bjontegaard_summary(0.9 * rates, psnrs, rates.T, psnrs.T, path=path)
    assert delta == jrd_sweep.bjontegaard_summary(0.9 * rates, psnrs, rates.T, psnrs.T)
    numpy.testing.assert_allclose(delta, -10.0, atol=1e-6)
    with open(path, "rb") as file:
        stored = pickle.load(file)
    assert stored["bjontegaard_percent_saving"] == delta and stored["fit_quality"]["reliable"]
    figure = str(tmp_path / "rd.png")
    rd_sweep.plot_rate_distortion(
        [(numpy.array([0.1, 0.5]), numpy.array([30.0, 36.0]), "a", "o-")], "test", figure)
    assert os.path.getsize(figure) > 0


@pytest.mark.parametrize("index,gamma", [(0, 10000), (6, 96000)])
def test_port_reproduces_the_committed_curves(index, gamma, tmp_path):
    images = synthetic_kodak(seed=14)[..., 0]
    assert hashlib.sha1(images.tobytes()).hexdigest()[:10] == "6c3a64d647"
    (params_np, _) = load_params_artifact(
        os.path.join(RESULTS, "fixed_bw", f"1_{gamma}", "params_trained.npz"))
    (rates, psnrs) = rd_sweep.vary_gamma_fix_bin_widths(
        images[:2], {float(gamma): params_from_jax(params_np)}, [float(gamma)], 2,
        str(tmp_path))
    committed = os.path.join(RESULTS, "kodak_rd")
    rates_c = numpy.load(os.path.join(committed, f"rates_vary_gamma_{VARY_ID}.npy"))
    psnrs_c = numpy.load(os.path.join(committed, f"psnrs_vary_gamma_{VARY_ID}.npy"))
    assert rates_c.shape == (7, 24)
    print(f"gaps: {numpy.abs(rates[0] - rates_c[index, :2]).max():.2e} bpp, "
          f"{numpy.abs(psnrs[0] - psnrs_c[index, :2]).max():.2e} dB")
    numpy.testing.assert_allclose(rates[0], rates_c[index, :2], rtol=0, atol=1e-4)
    numpy.testing.assert_allclose(psnrs[0], psnrs_c[index, :2], rtol=0, atol=1e-3)
