"""PyTorch port: the three-optimiser training step against the JAX
package's ``train/step.py``, from one state carried across by
``state_from_jax`` and with the same noise, on the CPU in float32, at
2 x 32 x 32 with ``max_itvs=32`` as ``tests/test_train_step.py`` does.

A JAX key cannot be reproduced in PyTorch, so the tests draw the noise
the JAX step will draw (same key, same split) and hand it to the port
as a tensor.

What is compared, and how tightly:

- the *gradients* of the rate-distortion loss, per parameter, to 5e-5 of
  that parameter's largest gradient entry (measured: up to 2.3e-5 in the
  encoder, where the entropy and distortion paths meet, about 1e-6 in
  the decoder; float32 convolutions and sums in another order);
- the *Adam update* against optax on identical numpy gradients;
- after a step from the same state: the density table, the bin widths,
  the step counts and the grid's extent closely; Adam's moments like the
  gradients. The *parameters after Adam* are stated separately: Adam's
  early updates are ``lr * g / (|g| + 1e-8)``, so an entry whose
  gradient is near zero may move by the whole learning rate either way
  under a 1e-7 difference in ``g``. The bound that always holds is
  ``2 * lr = 2e-4`` per entry; measured here, the largest gap is 1.1e-6.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import functools

import jax
import jax.numpy as jnp
import numpy
import optax
import pytest
import torch

from autoencoder_based_image_compression_tpu import constants as jcsts
from autoencoder_based_image_compression_tpu.ops import density as jdens
from autoencoder_based_image_compression_tpu.train import step as jstep
from autoencoder_based_image_compression_tpu.train.checkpoint import _path_keys
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu.train.state import make_adam
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.train import step as tstep
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    AdamState,
    adam_update,
    current_lr,
    init_train_state,
    learning_rate,
    map_state,
)

GAMMA = 10000.0
PPI = csts.NB_POINTS_PER_INTERVAL
MAX_ITVS = 32
LATENT_SHAPE = (2, 2, 2, 128)
GRAD_RTOL_OF_MAX = 5e-5
ARCHS = pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])


def _jax_arrays(state):
    return {key: numpy.asarray(leaf) for (key, leaf) in _path_keys(state)}


def _noise(key):
    """The uniform noise ``add_uniform_noise`` draws from ``key``."""
    return numpy.asarray(jax.random.uniform(key, LATENT_SHAPE, jnp.float32, -0.5, 0.5))


def _t(array):
    return torch.from_numpy(numpy.array(array))


@functools.lru_cache(maxsize=None)
def _setup(learn_bin_widths, seed=0):
    """A JAX state one ``train_step`` old (so Adam's moments and count
    are not zero), the same state in the port, both sets of functions
    and a uint8 batch. Built once per architecture: no step function
    writes into a state it is given."""
    jax_fns = jstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    torch_fns = tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    rng = numpy.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(2, 32, 32, 1)).astype(numpy.uint8)
    jax_state = jax_init(jax.random.PRNGKey(seed), GAMMA, bin_width_init=1.0,
                         learn_bin_widths=learn_bin_widths, max_itvs=MAX_ITVS)
    jax_state = jax_fns["train_step"](jax_state, jnp.asarray(batch), jax.random.PRNGKey(5))
    return (jax_state, state_from_jax(_jax_arrays(jax_state)), jax_fns, torch_fns, batch)


def _assert_close_to_max(got, expected, rtol_of_max, what):
    scale = float(numpy.abs(expected).max())
    gap = float(numpy.abs(got.astype(numpy.float64) - expected).max())
    assert gap <= rtol_of_max * scale + 1e-12, f"{what}: gap {gap:.3e}, largest entry {scale:.3e}"


def _assert_states_close(got, expected, what):
    """``got`` (port) and ``expected`` (JAX) as checkpoint-key dicts."""
    assert set(got) == set(expected)
    gaps = {}
    for (key, value) in expected.items():
        if key.startswith(".params"):
            gaps[key] = float(numpy.abs(got[key] - value).max())
            assert gaps[key] <= 2 * csts.LR_EAE, f"{what} {key}: {gaps[key]:.3e}"
        elif ".mu[" in key or ".nu[" in key:
            # Moments are linear (mu) and quadratic (nu) in the gradient.
            _assert_close_to_max(got[key], value, 4 * GRAD_RTOL_OF_MAX, f"{what} {key}")
        elif key == ".density.parameters":
            numpy.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5)
        elif key == ".bin_widths":
            numpy.testing.assert_allclose(got[key], value, rtol=1e-6)
        else:  # the counts, the step, the grid's extent
            assert got[key].dtype == value.dtype and got[key] == value, f"{what} {key}"
    return max(gaps.values())


def test_carried_state_is_the_same_state():
    (jax_state, torch_state, _, _, _) = _setup(False)
    arrays = _jax_arrays(jax_state)
    back = state_to_jax(torch_state)
    assert set(back) == set(arrays)
    for key in arrays:
        numpy.testing.assert_array_equal(back[key], arrays[key])
    assert int(torch_state.step) == 1 and int(torch_state.opt_eae.count) == 1
    assert torch_state.params["weights_2"].shape == (128, 128, 5, 5)
    assert torch_state.opt_eae.mu["weights_1"].shape == (128, 1, 9, 9)


@ARCHS
def test_training_fct_matches_jax(learn_bin_widths):
    (jax_state, torch_state, jax_fns, torch_fns, batch) = _setup(learn_bin_widths)
    key = jax.random.PRNGKey(7)
    expected = jax_fns["training_fct"](jax_state, jnp.asarray(batch), key)
    got = torch_fns["training_fct"](torch_state, _t(batch), _t(_noise(key)))
    assert int(got.density.nb_itvs_per_side) == int(expected.density.nb_itvs_per_side)
    # One SGD step of lr 0.2 on table entries of O(0.3); the gradient is
    # a scatter-add over 8 samples a map.
    numpy.testing.assert_allclose(got.density.parameters.numpy(),
                                  numpy.asarray(expected.density.parameters),
                                  rtol=1e-5, atol=1e-5)
    assert not torch.equal(got.density.parameters, torch_state.density.parameters)
    # Nothing else moves in the density phase.
    for name in got.params:
        assert got.params[name] is torch_state.params[name]
    assert int(got.step) == int(torch_state.step)


@ARCHS
def test_rd_gradients_match_jax_grad(learn_bin_widths):
    (jax_state, torch_state, _, _, batch) = _setup(learn_bin_widths)
    key = jax.random.PRNGKey(11)
    grad_fn = jax.grad(jstep._rd_loss, argnums=(0, 1), has_aux=True)
    ((grads_params, grads_bw), (rec_error, approx_entropy)) = grad_fn(
        jax_state.params, jax_state.bin_widths, jnp.asarray(batch), key, jax_state.density,
        GAMMA, learn_bin_widths, PPI, MAX_ITVS)
    noise = _t(_noise(key))
    (got_params, got_bw, loss) = tstep.rd_gradients(torch_state, _t(batch), noise, GAMMA,
                                                    learn_bin_widths, PPI, MAX_ITVS)
    # The model-axis loss at M = 1: the state as a stack of one.
    stacked = map_state(lambda leaf: leaf.unsqueeze(0), torch_state)
    visible_units = _t(batch).to(torch.float32)
    y = conv_eae.encode_stacked(stacked.params, visible_units, learn_bin_widths)
    (_, (got_rec, got_entropy)) = tstep._rd_loss(
        stacked.params, stacked.bin_widths, stacked.density, visible_units, y, [noise],
        torch.tensor([GAMMA]), learn_bin_widths, PPI, MAX_ITVS)
    # rec_error: a mean of sums over 1,024 squared errors up to 255^2.
    numpy.testing.assert_allclose(float(got_rec), float(rec_error), rtol=1e-5)
    numpy.testing.assert_allclose(float(got_entropy), float(approx_entropy), rtol=1e-5)
    assert not loss.requires_grad
    got_params = params_to_jax(got_params)  # conv gradients back to HWIO
    assert set(got_params) == set(grads_params)
    for (name, expected) in grads_params.items():
        _assert_close_to_max(got_params[name], numpy.asarray(expected), GRAD_RTOL_OF_MAX,
                             f"grad {name}")
    if learn_bin_widths:
        _assert_close_to_max(got_bw.numpy(), numpy.asarray(grads_bw), GRAD_RTOL_OF_MAX,
                             "grad bin_widths")
    else:
        assert got_bw is None


@pytest.mark.parametrize("count", [0, 3, 1499998, 1999999, 2500000])
def test_adam_matches_optax_on_identical_gradients(count):
    """Three updates from ``count``: across both learning-rate
    boundaries of gamma < 60000 (1,500,000 and 2,000,000)."""
    rng = numpy.random.default_rng(count)
    shapes = {"weights_1": (9, 9, 1, 8), "gamma_1": (8, 8), "beta_1": (8,)}
    params = {k: rng.standard_normal(s).astype(numpy.float32) for (k, s) in shapes.items()}
    mu = {k: rng.standard_normal(s).astype(numpy.float32) for (k, s) in shapes.items()}
    nu = {k: rng.uniform(0.1, 2.0, s).astype(numpy.float32) for (k, s) in shapes.items()}
    adam = make_adam(GAMMA)
    opt_state = adam.init({k: jnp.asarray(v) for (k, v) in params.items()})
    opt_state = (opt_state[0]._replace(count=jnp.asarray(count, jnp.int32),
                                       mu={k: jnp.asarray(v) for (k, v) in mu.items()},
                                       nu={k: jnp.asarray(v) for (k, v) in nu.items()}),
                 opt_state[1]._replace(count=jnp.asarray(count, jnp.int32)))
    jax_params = {k: jnp.asarray(v) for (k, v) in params.items()}
    torch_params = {k: _t(v) for (k, v) in params.items()}
    torch_opt = AdamState(torch.tensor(count, dtype=torch.int32),
                          {k: _t(v) for (k, v) in mu.items()},
                          {k: _t(v) for (k, v) in nu.items()})
    for i in range(3):
        # Gradients from 1e-9 to 1e3: the update is sign-like for all
        # but the smallest.
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 4, s)).astype(
            numpy.float32) for (k, s) in shapes.items()}
        (updates, opt_state) = adam.update({k: jnp.asarray(v) for (k, v) in grads.items()},
                                           opt_state, jax_params)
        new_jax_params = optax.apply_updates(jax_params, updates)
        (new_torch_params, torch_opt) = adam_update({k: _t(v) for (k, v) in grads.items()},
                                                    torch_opt, torch_params, GAMMA)
        lr = current_lr(GAMMA, count + i)
        assert float(learning_rate(GAMMA, torch.tensor(count + i))) == pytest.approx(lr, rel=1e-6)
        for k in shapes:
            # The update itself, in units of the learning rate: same
            # float32 expression, the power 0.9^count may differ by an ulp.
            got = (new_torch_params[k] - torch_params[k]).numpy() / lr
            expected = numpy.asarray(new_jax_params[k] - jax_params[k]) / lr
            numpy.testing.assert_allclose(got, expected, rtol=1e-4, atol=2e-3, err_msg=k)
            numpy.testing.assert_allclose(torch_opt.mu[k].numpy(),
                                          numpy.asarray(opt_state[0].mu[k]), rtol=1e-6)
            numpy.testing.assert_allclose(torch_opt.nu[k].numpy(),
                                          numpy.asarray(opt_state[0].nu[k]), rtol=1e-6)
        (jax_params, torch_params) = (new_jax_params, new_torch_params)
    assert int(torch_opt.count) == int(opt_state[0].count) == int(opt_state[1].count) == count + 3


def test_current_lr_steps_down_at_the_boundaries():
    for gamma in (10000.0, 70000.0, 90000.0):
        (b0, b1) = csts.lr_boundaries(gamma)
        assert (b0, b1) == jcsts.lr_boundaries(gamma)
        for (step, expected) in ((0, 1e-4), (b0 - 1, 1e-4), (b0, 1e-5), (b1 - 1, 1e-5),
                                 (b1, 1e-6)):
            assert current_lr(gamma, step) == pytest.approx(expected)
            assert float(learning_rate(gamma, torch.tensor(step))) == pytest.approx(expected)


@ARCHS
def test_training_eae_bw_matches_jax(learn_bin_widths):
    (jax_state, torch_state, jax_fns, torch_fns, batch) = _setup(learn_bin_widths)
    key = jax.random.PRNGKey(13)
    expected = jax_fns["training_eae_bw"](jax_state, jnp.asarray(batch), key)
    got = torch_fns["training_eae_bw"](torch_state, _t(batch), _t(_noise(key)))
    gap = _assert_states_close(state_to_jax(got), _jax_arrays(expected), "training_eae_bw")
    print("largest parameter gap after Adam", gap)
    assert gap <= 1e-5  # measured 1.1e-6; the bound that must hold is 2e-4
    assert int(got.step) == 2 and int(got.opt_eae.count) == 2
    # The density is an input of this phase, not a variable.
    assert got.density.parameters is torch_state.density.parameters
    if not learn_bin_widths:
        assert got.bin_widths is torch_state.bin_widths


@ARCHS
def test_train_step_matches_jax(learn_bin_widths):
    (jax_state, torch_state, jax_fns, torch_fns, batch) = _setup(learn_bin_widths)
    key = jax.random.PRNGKey(17)
    (key_fct, key_eae) = jax.random.split(key)
    expected = jax_fns["train_step"](jax_state, jnp.asarray(batch), key)
    got = torch_fns["train_step"](torch_state, _t(batch),
                                  (_t(_noise(key_fct)), _t(_noise(key_eae))))
    gap = _assert_states_close(state_to_jax(got), _jax_arrays(expected), "train_step")
    assert gap <= 1e-5
    # The autoencoder phase saw the UPDATED density: feeding it the old
    # table gives other gradients.
    stale = torch_fns["training_eae_bw"](torch_state, _t(batch), _t(_noise(key_eae)))
    assert not torch.equal(stale.opt_eae.mu["weights_3"], got.opt_eae.mu["weights_3"])


@ARCHS
def test_evaluation_matches_jax(learn_bin_widths):
    (jax_state, torch_state, jax_fns, torch_fns, batch) = _setup(learn_bin_widths)
    key = jax.random.PRNGKey(19)
    expected = jax_fns["evaluation"](jax_state, jnp.asarray(batch), key)
    got = torch_fns["evaluation"](torch_state, _t(batch), _t(_noise(key)))
    names = ("scaled_approx_entropy", "rec_error", "loss_density", "y",
             "approx_entropy_per_map", "areas_under_pdfs", "weight_decay")
    assert len(got) == len(expected) == len(names)
    for (name, g, e) in zip(names, got, expected):
        assert not g.requires_grad
        # Latents of O(1) through three float32 convolutions: atol 1e-5.
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(e), rtol=2e-5,
                                      atol=1e-5 if name == "y" else 0, err_msg=name)


def test_train_epoch_is_the_loop_of_train_steps_and_matches_jax():
    (jax_state, torch_state, jax_fns, torch_fns, _) = _setup(True)
    rng = numpy.random.default_rng(3)
    dataset = rng.integers(0, 256, size=(6, 32, 32, 1)).astype(numpy.uint8)
    rows = numpy.array([[4, 1], [0, 5], [2, 3]], numpy.int32)
    key = jax.random.PRNGKey(23)
    noises = []
    for subkey in jax.random.split(key, rows.shape[0]):
        (key_fct, key_eae) = jax.random.split(subkey)
        noises.append((_t(_noise(key_fct)), _t(_noise(key_eae))))
    got = torch_fns["train_epoch"](torch_state, _t(dataset), rows, noises)
    by_hand = torch_state
    for (batch_rows, noise) in zip(rows, noises):
        by_hand = torch_fns["train_step"](by_hand, _t(dataset[batch_rows]), noise)
    (a, b) = (state_to_jax(got), state_to_jax(by_hand))
    for key_ in a:
        numpy.testing.assert_array_equal(a[key_], b[key_])
    expected = jax_fns["train_epoch"](jax_state, jnp.asarray(dataset), jnp.asarray(rows), key)
    assert int(got.step) == int(expected.step) == 4
    assert int(got.density.nb_itvs_per_side) == int(expected.density.nb_itvs_per_side)
    # Three steps on: the gaps of one step compound, so the parameters
    # are held to the bound that always holds (2 * lr a step).
    for (name, value) in params_to_jax(got.params).items():
        assert numpy.abs(value - numpy.asarray(expected.params[name])).max() <= 3 * 2e-4
    numpy.testing.assert_allclose(got.density.parameters.numpy(),
                                  numpy.asarray(expected.density.parameters),
                                  rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError):
        torch_fns["train_epoch"](torch_state, _t(dataset), rows, noises[:2])


# --- the port alone, with a generator: the JAX package's own assertions ---

def _fresh(learn_bin_widths, seed=0, **kwargs):
    state = init_train_state(torch.Generator().manual_seed(seed), bin_width_init=1.0,
                             learn_bin_widths=learn_bin_widths, max_itvs=MAX_ITVS, device="cpu",
                             **kwargs)
    fns = tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    rng = numpy.random.default_rng(seed)
    batch = _t(rng.integers(0, 256, size=(2, 32, 32, 1)).astype(numpy.uint8))
    return (state, fns, batch)


def test_training_fct_decreases_density_loss():
    (state, fns, batch) = _fresh(True)
    eval_noise = torch.rand(LATENT_SHAPE, generator=torch.Generator().manual_seed(1)) - 0.5
    noise = torch.Generator().manual_seed(2)
    before = float(fns["evaluation"](state, batch, eval_noise)[2])
    for _ in range(30):
        state = fns["training_fct"](state, batch, noise)
    after = float(fns["evaluation"](state, batch, eval_noise)[2])
    assert after < before


def test_train_step_decreases_rd_loss():
    (state, fns, batch) = _fresh(False)
    eval_noise = torch.rand(LATENT_SHAPE, generator=torch.Generator().manual_seed(1)) - 0.5
    noise = torch.Generator().manual_seed(2)

    def rd_loss(state):
        (scaled_entropy, rec_error, *_rest) = fns["evaluation"](state, batch, eval_noise)
        return float(scaled_entropy) + float(rec_error)

    for _ in range(20):  # density pre-fit, so that the entropy term means something
        state = fns["training_fct"](state, batch, noise)
    before = rd_loss(state)
    for _ in range(60):
        state = fns["train_step"](state, batch, noise)
    assert rd_loss(state) < before
    assert int(state.step) == 60 and int(state.opt_eae.count) == 60


@ARCHS
def test_projections_hold_after_updates(learn_bin_widths):
    (state, fns, batch) = _fresh(learn_bin_widths)
    noise = torch.Generator().manual_seed(3)
    for _ in range(5):
        state = fns["train_step"](state, batch, noise)
    for i in ((1, 2, 5, 6) if learn_bin_widths else (1, 2, 3, 4, 5, 6)):
        gamma = state.params[f"gamma_{i}"].numpy()
        numpy.testing.assert_allclose(gamma, gamma.T, rtol=1e-6)
        assert gamma.min() >= csts.MIN_GAMMA_BETA - 1e-9
        assert state.params[f"beta_{i}"].min() >= csts.MIN_GAMMA_BETA - 1e-9
    bw = state.bin_widths.numpy()
    assert bw.min() >= csts.MIN_BW - 1e-9 and bw.max() <= csts.MAX_BW + 1e-9
    # Dead density cells stay pinned at the padding value.
    mask = dens.active_mask(state.density.nb_itvs_per_side, PPI, MAX_ITVS).numpy()
    dead = state.density.parameters.numpy()[:, mask == 0]
    assert dead.size
    numpy.testing.assert_allclose(dead, csts.LOW_PROJECTION, rtol=1e-6)
    assert state.density.parameters.min() >= numpy.float32(csts.LOW_PROJECTION)
    for leaf in (*state.params.values(), state.density.parameters, state.bin_widths):
        assert not leaf.requires_grad and bool(torch.isfinite(leaf).all())


def test_grid_expansion_during_training():
    # GDN bounds the latent amplitude, so scale the last conv kernel (the
    # latents are linear in it when bin widths are learned) to push |y|
    # past the grid's boundary.
    (state, fns, batch) = _fresh(True)
    params = dict(state.params)
    params["weights_3"] = 1000.0 * params["weights_3"]
    state = state._replace(params=params)
    before = int(state.density.nb_itvs_per_side)
    state = fns["training_fct"](state, batch, torch.Generator().manual_seed(0))
    after = int(state.density.nb_itvs_per_side)
    assert before < after <= MAX_ITVS
    assert state.density.nb_itvs_per_side.dtype == torch.int32


def test_bw_warmup_tightens_early_clip():
    fns = tstep.make_step_fns(GAMMA, True, max_itvs=MAX_ITVS, bw_warmup_steps=100,
                              bw_warmup_max=1.0)
    (state, _, batch) = _fresh(True, seed=1)
    state = state._replace(bin_widths=torch.full_like(state.bin_widths, 3.0))
    noise = torch.Generator().manual_seed(2)
    early = fns["train_step"](state, batch, noise)
    assert float(early.bin_widths.max()) <= 1.0 + 1e-6
    late = state._replace(step=torch.tensor(1000, dtype=torch.int32))
    late = fns["train_step"](late, batch, noise)
    assert float(late.bin_widths.max()) > 1.5


def test_expansion_saturates_at_capacity_like_jax():
    # Capacity overflow: the extent stops at max_itvs in both packages.
    table = dens.init_density_table(2, PPI, MAX_ITVS, 10)
    grown = dens.expand_table(table, torch.tensor(1.0e4), PPI, MAX_ITVS)
    expected = jdens.expand_table(jdens.init_density_table(2, PPI, MAX_ITVS, 10),
                                  jnp.asarray(1.0e4, jnp.float32), PPI, MAX_ITVS)
    assert int(grown.nb_itvs_per_side) == int(expected.nb_itvs_per_side) == MAX_ITVS


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(torch.Generator().manual_seed(0), learn_bin_widths=True)
