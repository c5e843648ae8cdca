"""PyTorch port: the latent-analysis tooling (``eval/analysis.py``,
``cli/latent_analysis.py``, ``cli/visualize_model.py``) against the JAX
package's, on one initial ``conv_eae`` carried across (the Pallas GDN in
interpret mode on the JAX side, the kernels' plain versions on the CPU
on the port's).

Tolerances: latents within rtol 1e-5 / atol 1e-4 (as
``tests/test_torch_transforms.py`` holds the encoder);
uint8 reconstructions at most one level apart, in at most 1e-3 of the
pixels (a float32 decode that lands a hair from a rounding boundary;
measured: equal); the Laplace fits of the latents within 1e-3 (relative
for the scales); the figures' arrays as the latents, the rest equal.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import functools
import os

import jax
import jax.numpy as jnp
import numpy
import PIL.Image
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import latent_analysis as jax_latent_cli
from autoencoder_based_image_compression_tpu.cli import visualize_model as jax_visualize_cli
from autoencoder_based_image_compression_tpu.eval import analysis as jax_analysis
from autoencoder_based_image_compression_tpu.models import conv_eae as jconv
from autoencoder_based_image_compression_tpu.ops import density as jdens
from autoencoder_based_image_compression_tpu.ops.quantization import add_uniform_noise
from autoencoder_based_image_compression_tpu.train import checkpoint as jcheckpoint
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch.cli import latent_analysis, visualize_model
from autoencoder_based_image_compression_tpu_torch.eval import analysis
from autoencoder_based_image_compression_tpu_torch.train import checkpoint
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

ARCHS = pytest.mark.parametrize("learned", [True, False], ids=["learned", "fixed"])
SUFFIX = {True: ("learning_bw", "1_10000"), False: ("fixed_bw", "1_10000")}


@functools.lru_cache(maxsize=None)
def _params(learned, seed=0):
    jax_params = jconv.init_conv_eae_params(jax.random.PRNGKey(seed), learned)
    return (jax_params, checkpoint.params_from_jax(
        {k: numpy.asarray(v) for (k, v) in jax_params.items()}))


def _assert_uint8_close(got, expected):
    assert got.dtype == expected.dtype == numpy.uint8 and got.shape == expected.shape
    gap = numpy.abs(got.astype(int) - expected.astype(int))
    assert gap.max() <= 1 and numpy.mean(gap > 0) <= 1e-3


@ARCHS
def test_activate_latent_variable_matches_jax(learned):
    (jax_params, params) = _params(learned)
    map_mean = numpy.random.default_rng(1).normal(0, 0.5, 128).astype(numpy.float32)
    for (row, col) in ((2, 3), (4, 5)):
        expected = jax_analysis.activate_latent_variable(jax_params, learned, 8, 8, row, col, 5,
                                                         10.0, map_mean)
        got = analysis.activate_latent_variable(params, learned, 8, 8, row, col, 5, 10.0,
                                                map_mean)
        assert got.shape == (128, 128)
        _assert_uint8_close(got, expected)


def test_activation_is_translation_covariant():
    # The probe's purpose, as tests/test_analysis.py checks it.
    (_, params) = _params(True)
    map_mean = numpy.zeros(128, numpy.float32)
    rec = analysis.activate_latent_variable(params, True, 8, 8, 2, 3, 5, 10.0, map_mean)
    shifted = analysis.activate_latent_variable(params, True, 8, 8, 4, 5, 5, 10.0, map_mean)
    numpy.testing.assert_array_equal(rec[16:96, 16:96][:64, :64],
                                     shifted[48:128, 48:128][:64, :64])


@ARCHS
def test_mask_maps_matches_jax(learned):
    (jax_params, params) = _params(learned)
    y = numpy.random.default_rng(2).normal(0, 5, size=(2, 4, 4, 128)).astype(numpy.float32)
    map_mean = numpy.mean(y, axis=(0, 1, 2))
    expected = jax_analysis.mask_maps(y, jax_params, learned, 7, map_mean)
    got = analysis.mask_maps(y, params, learned, 7, map_mean)
    assert got.shape == (2, 64, 64)
    _assert_uint8_close(got, expected)


def test_fit_maps_and_joint_fit_equal_jax():
    rng = numpy.random.default_rng(3)
    y = numpy.stack([rng.laplace(loc, scale, size=(4, 16, 16)) for (loc, scale) in
                     ((-1.0, 0.5), (0.0, 1.5), (2.0, 3.0))], axis=3).astype(numpy.float32)
    (locations, scales) = analysis.fit_maps(y)
    (jax_locations, jax_scales) = jax_analysis.fit_maps(y)
    numpy.testing.assert_array_equal(locations, jax_locations)
    numpy.testing.assert_array_equal(scales, jax_scales)
    numpy.testing.assert_allclose(scales, [0.5, 1.5, 3.0], rtol=0.1)
    assert analysis.fit_latents_jointly(y) == jax_analysis.fit_latents_jointly(y)


# --- The command lines, on one checkpoint written by the JAX package.

@pytest.fixture(scope="module", params=[True, False], ids=["learned", "fixed"])
def model(request, tmp_path_factory):
    """``(learned, results_root, images.npy)``: a JAX ``model_0`` checkpoint
    of an initial state and four 64 x 64 luminance images."""
    learned = request.param
    root = tmp_path_factory.mktemp("analysis")
    state = jax_init(jax.random.PRNGKey(4), 10000.0, 1.0, learned)
    jcheckpoint.save_checkpoint(str(root.joinpath(*SUFFIX[learned], "model_0")), state)
    images = numpy.random.default_rng(5).integers(0, 256, size=(4, 64, 64)).astype(numpy.uint8)
    numpy.save(root / "images.npy", images)
    return (learned, str(root), str(root / "images.npy"))


def _cli_args(model, command, out_dir):
    (learned, root, images) = model
    return ([command] if command else []) + ["1.0", "10000.0", "0", "--results_root", root,
                                             "--out_dir", out_dir] + (
        ["--learn_bin_widths"] if learned else [])


def test_latent_analysis_fit_matches_jax(model, tmp_path):
    (_, _, images) = model
    (ours, theirs) = (str(tmp_path / "port"), str(tmp_path / "jax"))
    latent_analysis.main(_cli_args(model, "fit", ours) + ["--path_to_kodak", images,
                                                          "--device", "cpu"])
    jax_latent_cli.main(_cli_args(model, "fit", theirs) + ["--path_to_kodak", images])
    for name in ("laplace_locations.npy", "laplace_scales.npy"):
        (got, expected) = (numpy.load(os.path.join(d, name)) for d in (ours, theirs))
        assert got.shape == (128,) and numpy.all(numpy.isfinite(got))
        numpy.testing.assert_allclose(got, expected, rtol=1e-3, atol=1e-3, err_msg=name)
    assert numpy.all(numpy.load(os.path.join(ours, "laplace_scales.npy")) > 0)


@pytest.mark.parametrize("command", ["activate", "mask"])
def test_latent_analysis_images_match_jax(model, command, tmp_path):
    (_, _, images) = model
    (ours, theirs) = (str(tmp_path / "port"), str(tmp_path / "jax"))
    latent_analysis.main(_cli_args(model, command, ours) + ["--path_to_kodak", images,
                                                            "--idx_map", "3", "--device",
                                                            "cpu"])
    jax_latent_cli.main(_cli_args(model, command, theirs) + ["--path_to_kodak", images,
                                                             "--idx_map", "3"])
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == (2 if command == "activate" else 4)
    for name in names:
        (got, expected) = (numpy.asarray(PIL.Image.open(os.path.join(d, name)))
                           for d in (ours, theirs))
        _assert_uint8_close(got, expected)
    if command == "activate":
        assert got.shape == (256, 256)


def test_visualize_model_arrays_match_jax(model):
    (learned, root, images) = model
    state = checkpoint.load_checkpoint(
        os.path.join(root, *SUFFIX[learned], "model_0"),
        init_train_state(torch.Generator().manual_seed(0), 1.0, learned, device="cpu"))
    jax_state = jcheckpoint.load_checkpoint(os.path.join(root, *SUFFIX[learned], "model_0"),
                                            jax_init(jax.random.PRNGKey(0), 10000.0, 1.0,
                                                     learned))
    batch = numpy.load(images)[:2]
    y = jconv.encode(jax_state.params, jnp.asarray(batch[..., None].astype(numpy.float32)),
                     learned)
    key = jax.random.PRNGKey(1)
    y_tilde = add_uniform_noise(key, y, jax_state.bin_widths)
    eps = jax.random.uniform(key, y.shape, jnp.float32, minval=-0.5, maxval=0.5)
    got = visualize_model.model_arrays(state, batch, learned, 4,
                                       torch.from_numpy(numpy.array(eps)))
    numpy.testing.assert_allclose(got["y"], numpy.asarray(y), rtol=1e-5, atol=1e-4)
    numpy.testing.assert_allclose(got["y_tilde"], numpy.asarray(y_tilde), rtol=1e-5, atol=1e-4)
    numpy.testing.assert_array_equal(got["pdfs"],
                                     numpy.asarray(jax_state.density.parameters)[:4])
    numpy.testing.assert_array_equal(got["weights_encoder"],
                                     numpy.asarray(jax_state.params["weights_1"]))
    numpy.testing.assert_array_equal(got["weights_decoder"],
                                     numpy.asarray(jax_state.params["weights_6"]))
    for i in visualize_model.GDN_SITES:
        gamma = numpy.asarray(jax_state.params[f"gamma_{i}"])
        expected = numpy.round(255.0 * (gamma - gamma.min()) / (gamma.max() - gamma.min()))
        numpy.testing.assert_array_equal(got["gdn_images"][i], expected.astype(numpy.uint8))
    numpy.testing.assert_allclose(got["areas"], numpy.asarray(
        jdens.area_under_piecewise_linear_functions(
            jax_state.density.parameters, jax_state.density.nb_itvs_per_side, 5, 64)),
        rtol=1e-6)


def test_visualize_model_writes_the_jax_figures(model, tmp_path):
    (_, _, images) = model
    (ours, theirs) = (str(tmp_path / "port"), str(tmp_path / "jax"))
    visualize_model.main(_cli_args(model, None, ours) + ["--path_to_images", images,
                                                         "--device", "cpu"])
    jax_visualize_cli.main(_cli_args(model, None, theirs) + ["--path_to_images", images])
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 4 + 2 + 2 + 4 + 1
    for name in names:
        assert os.path.getsize(os.path.join(ours, name)) > 0
        if name.startswith("gdn_gamma"):
            numpy.testing.assert_array_equal(
                *(numpy.asarray(PIL.Image.open(os.path.join(d, name))) for d in (ours, theirs)))
