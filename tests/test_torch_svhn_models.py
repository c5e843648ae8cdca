"""PyTorch port: the SVHN side's models (``models/dense_eae.py``,
``models/vae.py``) and their checkpoint converters against the JAX
package's, at the small widths of ``tests/test_svhn_models.py``
(192-32-16, ``max_itvs`` 32) on the CPU in float32.

Both packages start from one state, carried across by the converters,
and see the same noise: the tests draw the ``eps`` JAX draws from a key
and hand it to the port as a tensor.

What is compared, and how tightly:

- forward values (encoder, decoder, losses, the VAE's reparametrised
  sample): rtol 1e-5 (float32 matmuls summed in another order);
- one density SGD step: the table within 1e-5 absolute (a step of lr 0.2
  on entries of O(0.1); a sample a float32 ulp from a grid knot may fall
  into the neighbouring piece, which the test counts and bounds);
- one autoencoder step: the momentum buffers within 1e-4 of their
  largest entry (they are ``-lr * grad``), the weights within 1e-6
  absolute, the bin width within 1e-6;
- the VAE step: the same bounds.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import dense_eae as jdense
from autoencoder_based_image_compression_tpu.models import vae as jvae
from autoencoder_based_image_compression_tpu.ops import density as jdens
from autoencoder_based_image_compression_tpu.train import checkpoint as jcheckpoint
from autoencoder_based_image_compression_tpu_torch.models import dense_eae, vae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.train import checkpoint

WIDTHS = dict(nb_visible=192, nb_hidden=32, nb_y=16)
MAX_ITVS = 32
GAMMA = 1.0
VAE_WIDTHS = dict(nb_visible=192, nb_hidden=32, nb_z=8)
LEARNED = pytest.mark.parametrize("learned", [True, False], ids=["learned", "fixed"])


def _arrays(state):
    return {key: numpy.asarray(leaf) for (key, leaf) in jcheckpoint._path_keys(state)}


def _digits(seed, nb=10):
    rng = numpy.random.default_rng(seed)
    return rng.normal(0.0, 1.0, size=(nb, WIDTHS["nb_visible"])).astype(numpy.float32)


def _eps(key, shape):
    """The ``eps`` the JAX step functions draw from ``key``."""
    return numpy.asarray(jax.random.uniform(key, shape, jnp.float32, minval=-0.5, maxval=0.5))


def _dense_pair(seed=0, warm_steps=3):
    """A JAX dense state a few alternations old (momentum and density not
    at their initial values) and the same state in the port."""
    state = jdense.init_dense_eae_state(jax.random.PRNGKey(seed), max_itvs=MAX_ITVS, **WIDTHS)
    fns = jdense.make_dense_step_fns(GAMMA, True, MAX_ITVS)
    digits = _digits(100 + seed)
    for i in range(warm_steps):
        key = jax.random.PRNGKey(1000 + i)
        state = fns["training_eae_bw"](fns["training_fct"](state, digits, key), digits, key)
    return (state, checkpoint.dense_state_from_jax(_arrays(state)))


def _t(array):
    return torch.from_numpy(numpy.array(array))


def test_dense_converters_round_trip_and_keep_the_layout():
    (jax_state, state) = _dense_pair()
    arrays = _arrays(jax_state)
    back = checkpoint.dense_state_to_jax(state)
    assert set(back) == set(arrays)
    for key in arrays:
        numpy.testing.assert_array_equal(back[key], arrays[key])
        assert back[key].dtype == arrays[key].dtype, key
    assert state.params["we_l1"].shape == (192, 32)
    assert state.density.parameters.shape == (1, dens.table_width(dense_eae.PPI, MAX_ITVS))
    with pytest.raises(ValueError, match="dense EAE state"):
        checkpoint.dense_state_from_jax({k: v for (k, v) in arrays.items() if k != ".bin_width"})


def test_dense_init_shapes_and_distributions():
    state = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(0), 1.5,
                                           max_itvs=MAX_ITVS, device="cpu", **WIDTHS)
    reference = jdense.init_dense_eae_state(jax.random.PRNGKey(0), 1.5, max_itvs=MAX_ITVS,
                                            **WIDTHS)
    arrays = _arrays(reference)
    got = checkpoint.dense_state_to_jax(state)
    for key in arrays:
        assert got[key].shape == arrays[key].shape and got[key].dtype == arrays[key].dtype
    # The same initial density and bin width; the random weights share
    # their spread (N(0, 0.01) and N(0, 0.05)).
    numpy.testing.assert_array_equal(got[".density.parameters"], arrays[".density.parameters"])
    assert float(state.bin_width) == 1.5 and int(state.density.nb_itvs_per_side) == 10
    assert abs(float(state.params["we_l1"].std()) - 0.01) < 1e-3
    assert abs(float(state.params["wd_l1"].std()) - 0.05) < 5e-3


def test_dense_forward_matches_jax():
    (jax_state, state) = _dense_pair()
    digits = _digits(1)
    (hidden, y) = jdense.encoder(jax_state.params, digits)
    (got_hidden, got_y) = dense_eae.encoder(state.params, _t(digits))
    numpy.testing.assert_allclose(got_hidden.numpy(), hidden, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(got_y.numpy(), y, rtol=1e-5, atol=1e-6)
    (hidden_d, rec) = jdense.decoder(jax_state.params, y)
    (got_hidden_d, got_rec) = dense_eae.decoder(state.params, got_y)
    numpy.testing.assert_allclose(got_hidden_d.numpy(), hidden_d, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(got_rec.numpy(), rec, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(float(dense_eae.weights_decay(state.params)),
                                  float(jdense.weights_decay(jax_state.params)), rtol=1e-6)
    x = numpy.linspace(-2, 2, 9, dtype=numpy.float32)
    numpy.testing.assert_array_equal(dense_eae.leaky_relu(_t(x)).numpy(), jdense.leaky_relu(x))


def test_dense_evaluation_matches_jax():
    (jax_state, state) = _dense_pair()
    digits = _digits(2)
    key = jax.random.PRNGKey(3)
    expected = jdense.make_dense_step_fns(GAMMA, True, MAX_ITVS)["evaluation"](
        jax_state, digits, key)
    got = dense_eae.make_dense_step_fns(GAMMA, True, MAX_ITVS)["evaluation"](
        state, _t(digits), _t(_eps(key, (10, 16))))
    for (name, g, e) in zip(("approx-H", "scaled-H", "rec", "fct-loss", "y"), got, expected):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(e), rtol=1e-5, atol=1e-5,
                                      err_msg=name)


def _knot_flips(y_tilde_a, y_tilde_b):
    """Samples whose linear piece differs between the two packages."""
    pieces = [numpy.floor(dense_eae.PPI * numpy.asarray(v, numpy.float64)) for v in
              (y_tilde_a, y_tilde_b)]
    return int(numpy.sum(pieces[0] != pieces[1]))


def test_dense_training_fct_matches_jax():
    (jax_state, state) = _dense_pair()
    digits = _digits(4)
    key = jax.random.PRNGKey(5)
    eps = _eps(key, (10, 16))
    expected = jdense.make_dense_step_fns(GAMMA, True, MAX_ITVS)["training_fct"](
        jax_state, digits, key)
    got = dense_eae.make_dense_step_fns(GAMMA, True, MAX_ITVS)["training_fct"](
        state, _t(digits), _t(eps))
    assert int(got.density.nb_itvs_per_side) == int(expected.density.nb_itvs_per_side)
    (_, y) = jdense.encoder(jax_state.params, digits)
    (_, got_y) = dense_eae.encoder(state.params, _t(digits))
    bw = float(jax_state.bin_width)
    assert _knot_flips(numpy.asarray(y) + bw * eps, got_y.numpy() + bw * eps) == 0
    numpy.testing.assert_allclose(got.density.parameters.numpy(),
                                  numpy.asarray(expected.density.parameters), atol=1e-5)
    # The autoencoder's side of the state is untouched.
    for name in state.params:
        assert torch.equal(got.params[name], state.params[name])


@LEARNED
def test_dense_training_eae_bw_matches_jax(learned):
    (jax_state, state) = _dense_pair()
    digits = _digits(6)
    key = jax.random.PRNGKey(7)
    expected = jdense.make_dense_step_fns(GAMMA, learned, MAX_ITVS)["training_eae_bw"](
        jax_state, digits, key)
    got = dense_eae.make_dense_step_fns(GAMMA, learned, MAX_ITVS)["training_eae_bw"](
        state, _t(digits), _t(_eps(key, (10, 16))))
    for name in state.params:
        momentum = numpy.asarray(expected.momentum[name])
        gap = numpy.abs(got.momentum[name].numpy() - momentum).max()
        assert gap <= 1e-4 * numpy.abs(momentum).max() + 1e-12, f"momentum {name}: {gap:.3e}"
        numpy.testing.assert_allclose(got.params[name].numpy(),
                                      numpy.asarray(expected.params[name]), atol=1e-6,
                                      err_msg=name)
    numpy.testing.assert_allclose(float(got.bin_width), float(expected.bin_width), atol=1e-6)
    assert (float(got.bin_width) != float(state.bin_width)) == learned
    assert int(got.step) == int(expected.step) == int(state.step) + 1
    assert torch.equal(got.density.parameters, state.density.parameters)


def test_dense_bin_width_gradient_is_the_closed_form():
    # d/d(bw) of the loss through y + bw * eps, as autograd gives it,
    # against central differences of the loss in float64.
    (_, state) = _dense_pair()
    digits = _t(_digits(8)).double()
    eps = _t(_eps(jax.random.PRNGKey(9), (10, 16))).double()
    params = {k: v.double() for (k, v) in state.params.items()}
    parameters = state.density.parameters.double()

    def loss(bw):
        return dense_eae._loss_eae(params, bw, digits, eps, parameters, GAMMA, MAX_ITVS)[0]

    bw = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(loss(bw), bw)
    step = 1e-6
    with torch.no_grad():
        numeric = (loss(bw + step) - loss(bw - step)) / (2 * step)
    assert abs(float(grad) - float(numeric)) <= 1e-4 * abs(float(numeric))


def test_dense_noise_is_a_generator_or_the_draw():
    (_, state) = _dense_pair()
    fns = dense_eae.make_dense_step_fns(GAMMA, True, MAX_ITVS)
    digits = _t(_digits(10))
    eps = dense_eae.uniform_eps(torch.Generator().manual_seed(3), (10, 16), "cpu")
    assert float(eps.min()) >= -0.5 and float(eps.max()) < 0.5
    by_draw = fns["training_eae_bw"](state, digits, eps)
    by_generator = fns["training_eae_bw"](state, digits, torch.Generator().manual_seed(3))
    for name in state.params:
        assert torch.equal(by_draw.params[name], by_generator.params[name])
    with pytest.raises(ValueError, match="noise of shape"):
        fns["training_fct"](state, digits, eps[:5])


def test_dense_compute_rate_psnr_matches_jax():
    (jax_state, state) = _dense_pair()
    digits = _digits(11, nb=40)
    mean = numpy.random.default_rng(12).uniform(60, 200, 192).astype(numpy.float32)
    for bin_width_test in (0.5, 1.0, 3.0):
        (rate, rec) = jdense.compute_rate_psnr(jax_state, digits, mean, 50.0, bin_width_test)
        (got_rate, got_rec) = dense_eae.compute_rate_psnr(state, digits, mean, 50.0,
                                                          bin_width_test)
        assert abs(got_rate - rate) <= 1e-9, (bin_width_test, got_rate, rate)
        assert got_rec.dtype == numpy.uint8 and got_rec.shape == rec.shape
        # A level apart only where the float32 decode lands a hair from a
        # rounding boundary.
        assert numpy.abs(got_rec.astype(int) - rec).max() <= 1
        assert numpy.mean(got_rec != rec) <= 1e-3


def test_dense_overfit_decreases_the_objective():
    # The reference's overfit harness as an assertion (port only).
    digits = _t(_digits(13))
    state = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(1),
                                           max_itvs=MAX_ITVS, device="cpu", **WIDTHS)
    fns = dense_eae.make_dense_step_fns(GAMMA, True, MAX_ITVS)
    noise = torch.Generator().manual_seed(2)
    eps_eval = dense_eae.uniform_eps(torch.Generator().manual_seed(3), (10, 16), "cpu")

    def objective(state):
        (_, scaled, rec, _, _) = fns["evaluation"](state, digits, eps_eval)
        return float(scaled) + float(rec)

    for _ in range(30):
        state = fns["training_fct"](state, digits, noise)
    before = objective(state)
    for _ in range(200):
        eps = dense_eae.uniform_eps(noise, (10, 16), "cpu")
        state = fns["training_eae_bw"](fns["training_fct"](state, digits, eps), digits, eps)
    assert objective(state) < before
    assert float(state.bin_width) >= dense_eae.MIN_BW


# --- The VAE.

def _vae_pair(seed=0, warm_steps=2):
    state = jvae.init_vae_state(jax.random.PRNGKey(seed), **VAE_WIDTHS)
    step = jvae.make_vae_step_fn(1.0)
    digits = _digits(200 + seed, nb=16)
    for i in range(warm_steps):
        state = step(state, digits, jax.random.PRNGKey(2000 + i))
    return (state, checkpoint.vae_state_from_jax(_arrays(state)))


def _normal(key, shape):
    return numpy.asarray(jax.random.normal(key, shape, jnp.float32))


def test_vae_converters_round_trip():
    (jax_state, state) = _vae_pair()
    arrays = _arrays(jax_state)
    back = checkpoint.vae_state_to_jax(state)
    assert set(back) == set(arrays)
    for key in arrays:
        numpy.testing.assert_array_equal(back[key], arrays[key])
    assert int(state.step) == 2 and state.params["wr_l1"].shape == (192, 32)


@pytest.mark.parametrize("is_continuous", [True, False], ids=["gaussian", "binary"])
def test_vae_forward_and_vlb_match_jax(is_continuous):
    (jax_state, state) = _vae_pair()
    digits = _digits(3, nb=16)
    if not is_continuous:
        digits = (digits > 0).astype(numpy.float32)
    key = jax.random.PRNGKey(4)
    epsilon = _t(_normal(key, (16, 8)))
    expected = jvae.forward_pass(jax_state.params, digits, key, is_continuous)
    got = vae.forward_pass(state.params, _t(digits), epsilon, is_continuous)
    for (g, e) in zip(got, expected):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(e), rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(
        float(vae.opposite_vlb(state.params, _t(digits), epsilon, 0.7, is_continuous)),
        float(jvae.opposite_vlb(jax_state.params, digits, key, 0.7, is_continuous)), rtol=1e-5)
    numpy.testing.assert_allclose(
        float(vae.kl_divergence(got[0], got[1])),
        float(jvae.kl_divergence(expected[0], expected[1])), rtol=1e-5)


def test_vae_step_matches_jax():
    (jax_state, state) = _vae_pair()
    digits = _digits(5, nb=16)
    key = jax.random.PRNGKey(6)
    expected = jvae.make_vae_step_fn(1.0)(jax_state, digits, key)
    got = vae.make_vae_step_fn(1.0)(state, _t(digits), _t(_normal(key, (16, 8))))
    for name in state.params:
        momentum = numpy.asarray(expected.momentum[name])
        gap = numpy.abs(got.momentum[name].numpy() - momentum).max()
        assert gap <= 1e-4 * numpy.abs(momentum).max() + 1e-12, f"momentum {name}: {gap:.3e}"
        numpy.testing.assert_allclose(got.params[name].numpy(),
                                      numpy.asarray(expected.params[name]), atol=1e-6)
    assert int(got.step) == 3


def test_vae_generate_matches_jax_and_kl_is_zero_at_the_prior():
    (jax_state, state) = _vae_pair()
    key = jax.random.PRNGKey(7)
    expected = jvae.generate(jax_state.params, key, 5, nb_z=8)
    got = vae.generate(state.params, _t(_normal(key, (5, 8))), 5, nb_z=8)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(expected), rtol=1e-5, atol=1e-5)
    assert vae.generate(state.params, torch.Generator().manual_seed(0), 5, 8).shape == (5, 192)
    zeros = torch.zeros((4, 8))
    assert float(vae.kl_divergence(zeros, zeros)) == 0.0


def test_vae_training_decreases_the_vlb():
    digits = _t(_digits(8, nb=32))
    state = vae.init_vae_state(torch.Generator().manual_seed(7), device="cpu", **VAE_WIDTHS)
    step = vae.make_vae_step_fn(1.0)
    eps_eval = torch.randn((32, 8), generator=torch.Generator().manual_seed(8))
    before = float(vae.opposite_vlb(state.params, digits, eps_eval, 1.0))
    noise = torch.Generator().manual_seed(9)
    for _ in range(300):
        state = step(state, digits, noise)
    assert float(vae.opposite_vlb(state.params, digits, eps_eval, 1.0)) < before


# --- Checkpoints across the packages.

def test_dense_checkpoints_load_in_either_package(tmp_path):
    (jax_state, state) = _dense_pair()
    jax_template = jdense.init_dense_eae_state(jax.random.PRNGKey(9), max_itvs=MAX_ITVS,
                                               **WIDTHS)
    template = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(9),
                                              max_itvs=MAX_ITVS, device="cpu", **WIDTHS)
    # The port writes, JAX reads.
    checkpoint.save_checkpoint(str(tmp_path / "port"), state)
    loaded = jcheckpoint.load_checkpoint(str(tmp_path / "port"), jax_template)
    for (key, value) in _arrays(loaded).items():
        numpy.testing.assert_array_equal(value, _arrays(jax_state)[key])
    # JAX writes, the port reads.
    jcheckpoint.save_checkpoint(str(tmp_path / "jax"), jax_state)
    back = checkpoint.load_checkpoint(str(tmp_path / "jax"), template)
    assert isinstance(back, dense_eae.DenseEaeState)
    for (key, value) in checkpoint.dense_state_to_jax(back).items():
        numpy.testing.assert_array_equal(value, _arrays(jax_state)[key])
    with pytest.raises(FileExistsError):
        checkpoint.save_checkpoint(str(tmp_path / "port"), state)


def test_vae_checkpoint_of_the_port_loads_in_jax(tmp_path):
    # The reference package's own VAE trainer cannot write its sidecar
    # (it reads a density the VAE does not have); the port's can.
    (jax_state, state) = _vae_pair()
    path = str(tmp_path / "model")
    checkpoint.save_checkpoint(path, state)
    assert os.path.isfile(path + ".json")
    loaded = jcheckpoint.load_checkpoint(path, jvae.init_vae_state(jax.random.PRNGKey(1),
                                                                   **VAE_WIDTHS))
    for (key, value) in _arrays(loaded).items():
        numpy.testing.assert_array_equal(value, _arrays(jax_state)[key])
    with pytest.raises(AttributeError):
        jcheckpoint.save_checkpoint(str(tmp_path / "jax"), jax_state)
    template = vae.init_vae_state(torch.Generator().manual_seed(1), device="cpu", **VAE_WIDTHS)
    back = checkpoint.load_checkpoint(path, template)
    assert isinstance(back, vae.VaeState) and int(back.step) == 2
    with pytest.raises(TypeError, match="no checkpoint format"):
        checkpoint.save_checkpoint(str(tmp_path / "x"), (1, 2))


def test_state_kinds_do_not_load_into_each_other(tmp_path):
    (_, state) = _vae_pair()
    path = str(tmp_path / "vae")
    checkpoint.save_checkpoint(path, state)
    template = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(0),
                                              max_itvs=MAX_ITVS, device="cpu", **WIDTHS)
    with pytest.raises(ValueError, match="key mismatch"):
        checkpoint.load_checkpoint(path, template)


def test_the_shared_density_is_one_table():
    # SVHN's density is one scalar pdf for all latents (a (1, W) table),
    # and its geometry is the JAX package's.
    table = dens.init_density_table(1, dense_eae.PPI, MAX_ITVS, dense_eae.NB_ITVS_INIT)
    expected = jdens.init_density_table(1, dense_eae.PPI, MAX_ITVS, dense_eae.NB_ITVS_INIT)
    numpy.testing.assert_array_equal(table.parameters.numpy(), numpy.asarray(expected.parameters))
