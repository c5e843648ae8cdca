"""PyTorch port: initialisation, additive noise, the epoch loop and
the batched inference helpers against the JAX package on the same
seeded numpy inputs (CPU, float32). Random initial values cannot be
compared draw for draw (a JAX key has no PyTorch counterpart), so the
initialisers are held to the distributions and the counts.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import conv_eae as jax_conv_eae
from autoencoder_based_image_compression_tpu.ops.quantization import (
    add_uniform_noise as jax_add_uniform_noise,
)
from autoencoder_based_image_compression_tpu.train import checkpoint as jck
from autoencoder_based_image_compression_tpu.train import loop as jax_loop
from autoencoder_based_image_compression_tpu.train import step as jax_step
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.gdn import init_gdn_gamma
from autoencoder_based_image_compression_tpu_torch.ops.quantization import add_uniform_noise
from autoencoder_based_image_compression_tpu_torch.train import loop, step
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.image import subdivide_set

GAMMA = 10000.0
MAX_ITVS = 32


def test_init_gdn_gamma():
    gamma = init_gdn_gamma(torch.Generator().manual_seed(0), 128, csts.MIN_GAMMA_BETA)
    assert gamma.shape == (128, 128) and gamma.dtype == torch.float32
    assert torch.equal(gamma, gamma.t())
    assert float(gamma.min()) >= csts.MIN_GAMMA_BETA and float(gamma.max()) <= 0.01
    # U(2e-5, 0.01) symmetrised: mean 0.00501.
    assert float(gamma.mean()) == pytest.approx(0.00501, rel=0.02)
    for bad in (0.0, -1.0, 0.02):
        with pytest.raises(ValueError):
            init_gdn_gamma(torch.Generator().manual_seed(0), 8, bad)


@pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
def test_init_conv_eae_params(learn_bin_widths):
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(1), learn_bin_widths)
    reference = jax_conv_eae.init_conv_eae_params(jax.random.PRNGKey(1), learn_bin_widths)
    # Same names; the reference's shapes once carried back to its layouts.
    back = params_to_jax(params)
    assert {k: v.shape for (k, v) in back.items()} == {k: v.shape for (k, v) in reference.items()}
    assert conv_eae.nb_parameters(params) == jax_conv_eae.nb_parameters(reference)
    assert conv_eae.nb_parameters(params) == (1758848 if not learn_bin_widths
                                              else 1758848 - 2 * (128 * 128 + 128))
    for (name, std) in (("weights_1", 0.01), ("weights_2", 0.02), ("weights_3", 0.05),
                        ("weights_4", 0.05), ("weights_5", 0.02), ("weights_6", 0.01)):
        assert float(params[name].std()) == pytest.approx(std, rel=0.05), name
        assert abs(float(params[name].mean())) < std / 10
    for (name, value) in params.items():
        if name.startswith("biases"):
            assert not value.any()
        if name.startswith("beta"):
            assert bool((value == 1).all())
    # Born in the port's layouts: they convolve as they are.
    y = conv_eae.encode(params, torch.zeros(1, 32, 32, 1), learn_bin_widths)
    assert y.shape == (1, 2, 2, 128)
    assert conv_eae.decode(params, y, learn_bin_widths).shape == (1, 32, 32, 1)


def test_weight_l2_norm_does_not_depend_on_the_layout():
    reference = jax_conv_eae.init_conv_eae_params(jax.random.PRNGKey(2), False)
    params = params_from_jax({k: numpy.asarray(v) for (k, v) in reference.items()})
    # A sum of 1.7 million float32 squares, taken in another order.
    assert float(conv_eae.weight_l2_norm(params)) == pytest.approx(
        float(jax_conv_eae.weight_l2_norm(reference)), rel=1e-5)


def test_add_uniform_noise():
    rng = numpy.random.default_rng(0)
    data = rng.standard_normal((2, 3, 4, 8)).astype(numpy.float32)
    bin_widths = rng.uniform(0.8, 4.0, 8).astype(numpy.float32)
    key = jax.random.PRNGKey(3)
    noise = numpy.asarray(jax.random.uniform(key, data.shape, jnp.float32, -0.5, 0.5))
    expected = jax_add_uniform_noise(key, jnp.asarray(data), jnp.asarray(bin_widths))
    got = add_uniform_noise(torch.from_numpy(noise.copy()), torch.from_numpy(data),
                            torch.from_numpy(bin_widths))
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(expected))
    # From a generator: inside half a bin width on every channel, zero mean.
    big = torch.zeros(64, 16, 16, 8)
    drawn = add_uniform_noise(torch.Generator().manual_seed(0), big, torch.from_numpy(bin_widths))
    assert bool((drawn.abs() <= 0.5 * torch.from_numpy(bin_widths)).all())
    assert float(drawn.mean().abs()) < 0.01
    spread = drawn.reshape(-1, 8).std(0).numpy()
    numpy.testing.assert_allclose(spread, bin_widths / numpy.sqrt(12.0), rtol=0.03)
    with pytest.raises(ValueError):
        add_uniform_noise(torch.zeros(2, 3), torch.from_numpy(data), torch.from_numpy(bin_widths))


def test_subdivide_set():
    assert subdivide_set(20, 5) == 4
    with pytest.raises(ValueError):
        subdivide_set(21, 5)


def _states(learn_bin_widths):
    jax_state = jax_init(jax.random.PRNGKey(0), GAMMA, 1.0, learn_bin_widths, max_itvs=MAX_ITVS)
    arrays = {key: numpy.asarray(leaf) for (key, leaf) in jck._path_keys(jax_state)}
    return (jax_state, state_from_jax(arrays))


@pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
def test_encode_and_decode_mini_batches_match_jax(learn_bin_widths):
    (jax_state, state) = _states(learn_bin_widths)
    rng = numpy.random.default_rng(1)
    images = rng.integers(0, 256, size=(4, 32, 48, 1)).astype(numpy.uint8)
    expected = jax_loop.encode_mini_batches(images, jax_state.params, learn_bin_widths, 2)
    got = loop.encode_mini_batches(images, state.params, learn_bin_widths, 2)
    assert got.dtype == numpy.float32 and got.shape == (4, 2, 3, 128)
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)
    quantized = numpy.round(expected)
    rec_expected = jax_loop.decode_mini_batches(quantized, jax_state.params, learn_bin_widths, 2)
    rec = loop.decode_mini_batches(quantized, state.params, learn_bin_widths, 2)
    assert rec.dtype == numpy.uint8 and rec.shape == images.shape
    # uint8 after rounding: a float32 difference can flip a pixel by one.
    assert numpy.abs(rec.astype(int) - rec_expected.astype(int)).max() <= 1
    assert numpy.mean(rec != rec_expected) < 1e-3
    with pytest.raises(TypeError):
        loop.encode_mini_batches(images.astype(numpy.float32), state.params, learn_bin_widths, 2)
    with pytest.raises(ValueError):
        loop.encode_mini_batches(images, state.params, learn_bin_widths, 3)


def test_evaluate_full_matches_jax_on_the_same_noise():
    (jax_state, state) = _states(True)
    jax_fns = jax_step.make_step_fns(GAMMA, True, max_itvs=MAX_ITVS)
    fns = step.make_step_fns(GAMMA, True, max_itvs=MAX_ITVS)
    rng = numpy.random.default_rng(2)
    batch = rng.integers(0, 256, size=(2, 32, 32, 1)).astype(numpy.uint8)
    key = jax.random.PRNGKey(4)
    noise = torch.from_numpy(numpy.array(
        jax.random.uniform(key, (2, 2, 2, 128), jnp.float32, -0.5, 0.5)))
    expected = jax_loop.evaluate_full(jax_state, batch, jax_fns, GAMMA, key)
    got = loop.evaluate_full(state, batch, fns, GAMMA, noise)
    assert set(got) == set(expected)
    for (name, value) in expected.items():
        numpy.testing.assert_allclose(got[name], value, rtol=2e-5, atol=1e-6, err_msg=name)
    assert isinstance(got["nb_dead_maps"], int) and isinstance(got["rec_error"], float)
    four = loop.evaluate(state, batch, fns, GAMMA, noise)
    assert four == (got["mean_disc_entropy"], got["scaled_approx_entropy"], got["rec_error"],
                    got["loss_density"])


def test_pre_fit_and_epoch_drive_the_step_functions():
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=MAX_ITVS,
                             device="cpu")
    fns = step.make_step_fns(GAMMA, True, max_itvs=MAX_ITVS)
    rng = numpy.random.default_rng(3)
    training = rng.integers(0, 256, size=(6, 32, 32, 1)).astype(numpy.uint8)
    dataset = loop.device_resident_dataset(training, "cpu")
    assert dataset.dtype == torch.uint8 and dataset.device.type == "cpu"
    noise = torch.Generator().manual_seed(1)
    fitted = loop.preliminary_fitting(dataset, state, fns, 2, 2, noise)
    assert int(fitted.step) == 0  # the pre-fit moves the density only
    assert not torch.equal(fitted.density.parameters, state.density.parameters)
    assert fitted.params["weights_1"] is state.params["weights_1"]
    trained = loop.run_epoch_training(training, fitted, fns, 2, 3, noise,
                                      permutation=numpy.array([5, 0, 3, 1, 2, 4]))
    assert int(trained.step) == 3
    # The same permutation and the same generator state: the same epoch.
    again = loop.run_epoch_training(dataset, fitted, fns, 2, 3,
                                    torch.Generator().manual_seed(7),
                                    permutation=numpy.array([5, 0, 3, 1, 2, 4]))
    once_more = loop.run_epoch_training(dataset, fitted, fns, 2, 3,
                                        torch.Generator().manual_seed(7),
                                        permutation=numpy.array([5, 0, 3, 1, 2, 4]))
    assert torch.equal(again.params["weights_3"], once_more.params["weights_3"])
    with pytest.raises(ValueError):
        loop.preliminary_fitting(dataset, state, fns, 4, 1, noise)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            loop.device_resident_dataset(training)
