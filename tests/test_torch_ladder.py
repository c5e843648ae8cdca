"""PyTorch port: the whole-ladder trainer against the JAX package's
``train/ladder.py``, on the CPU in float32, at 2 x 32 x 32 with the two
gammas ``tests/test_ladder.py`` uses.

The JAX ladder is initialised, each of its models is carried across with
``state_from_jax`` (through ``ladder_slice_state``, which gives the
checkpoint structure), and both packages run a density pre-fit pass and
two ``train_step``s on the same batches. A JAX key cannot be reproduced
in PyTorch: the port is handed the noise JAX draws from
``jax.random.split(key, nb_models)`` and then ``jax.random.split(key_k)``.

Each step is compared *from the same state*: the port takes its second
``train_step`` from the JAX ladder's state after the first. From a fresh
state Adam's first updates are ``lr * g / (|g| + 1e-8)``, a sign: an
entry whose gradient is near zero moves by the learning rate either way
under a 1e-7 difference in ``g``, and the density model's gradient is
piecewise constant in the latents (eight samples a map here), so two
free-running trajectories drift apart by what such flips do. Measured
(this file, CPU): per step from the same state, 5 to 12 of 1,758,848
parameter entries differ by more than 1e-5 (each by 2e-4, the bound),
the others by 3.8e-6 at most; Adam's moments within 4.8e-5 of each
leaf's largest entry; the density table within 2.0e-6. Free-running, the
port's second step leaves 12,533 entries of the gamma 96,000 model more
than 1e-5 from the JAX ladder's, all inside the bound of 4e-4. The
port's ladder is one program over the stacked models and is held
against its own sequential single-model runs at the JAX package's
bounds for its vmapped ladder against single models; so is a ladder of
two learned-bin-width models, through the model-axis step
(``train.step.ModelAxisStep``) that the ladder's functions run with
fixed bin widths.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import functools
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu import constants as jcsts
from autoencoder_based_image_compression_tpu.train import checkpoint as jck
from autoencoder_based_image_compression_tpu.train import ladder as jladder
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.cli.train_ladder import GAMMAS_DEFAULT
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train import ladder as tladder
from autoencoder_based_image_compression_tpu_torch.train.state import (
    init_train_state,
    learning_rate,
    map_state,
)
from autoencoder_based_image_compression_tpu_torch.train.step import ModelAxisStep, make_step_fns

GAMMAS = [10000.0, 96000.0]
LATENT_SHAPE = (2, 2, 2, 128)
GRAD_RTOL_OF_MAX = 5e-5


def _batch(seed):
    rng = numpy.random.default_rng(seed)
    return rng.integers(16, 236, size=(2, 32, 32, 1)).astype(numpy.float32)


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _uniform(key):
    return _t(jax.random.uniform(key, LATENT_SHAPE, jnp.float32, -0.5, 0.5))


def _fct_noise(key):
    """What the JAX ladder's ``training_fct`` draws, per model."""
    return [_uniform(key_k) for key_k in jax.random.split(key, len(GAMMAS))]


def _step_noise(key):
    """What the JAX ladder's ``train_step`` draws, per model."""
    pairs = []
    for key_k in jax.random.split(key, len(GAMMAS)):
        (key_fct, key_eae) = jax.random.split(key_k)
        pairs.append((_uniform(key_fct), _uniform(key_eae)))
    return pairs


def _model_arrays(jax_ladder, k):
    sliced = jladder.ladder_slice_state(jax_ladder, k, GAMMAS[k])
    return {key: numpy.asarray(leaf) for (key, leaf) in jck._path_keys(sliced)}


def _carry(jax_ladder):
    return tladder.ladder_stack_states(
        [tck.state_from_jax(_model_arrays(jax_ladder, k)) for k in range(len(GAMMAS))])


@functools.lru_cache(maxsize=None)
def _trajectories():
    """The JAX ladder at the start, after the pre-fit pass and after each
    of two ``train_step``s; the port's ladder after the same call from
    the JAX ladder's state before it (``matched``), and running on its
    own from the start (``free``)."""
    jax_fns = jladder.make_ladder_step_fns(GAMMAS)
    torch_fns = tladder.make_ladder_step_fns(GAMMAS)
    jax_states = [jladder.init_ladder_state(jax.random.PRNGKey(0), GAMMAS)]
    free = [_carry(jax_states[0])]
    matched = [free[0]]
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    jax_states.append(jax_fns["training_fct"](jax_states[-1], jnp.asarray(_batch(7)), keys[0]))
    free.append(torch_fns["training_fct"](free[-1], _t(_batch(7)), _fct_noise(keys[0])))
    matched.append(free[-1])
    for (seed, key) in ((8, keys[1]), (9, keys[2])):
        noise = _step_noise(key)
        matched.append(torch_fns["train_step"](_carry(jax_states[-1]), _t(_batch(seed)), noise))
        free.append(torch_fns["train_step"](free[-1], _t(_batch(seed)), noise))
        jax_states.append(jax_fns["train_step"](jax_states[-1], jnp.asarray(_batch(seed)), key))
    return (jax_states, matched, free)


def _assert_close_to_max(got, expected, rtol_of_max, what):
    scale = float(numpy.abs(expected).max())
    gap = float(numpy.abs(got.astype(numpy.float64) - expected).max())
    assert gap <= rtol_of_max * scale + 1e-12, f"{what}: gap {gap:.3e}, largest {scale:.3e}"


def test_carried_ladder_is_the_same_ladder():
    (jax_states, torch_states, _) = _trajectories()
    for k in range(len(GAMMAS)):
        expected = _model_arrays(jax_states[0], k)
        got = tck.state_to_jax(tladder.ladder_slice_state(torch_states[0], k, GAMMAS[k]))
        assert set(got) == set(expected)
        for key in expected:
            numpy.testing.assert_array_equal(got[key], expected[key])
    assert torch_states[0].step.shape == (2,)
    assert torch_states[0].params["weights_1"].shape == (2, 128, 1, 9, 9)
    assert torch_states[0].density.nb_itvs_per_side.dtype == torch.int32


@pytest.mark.parametrize("k", range(len(GAMMAS)))
def test_training_fct_matches_jax(k):
    (jax_states, torch_states, _) = _trajectories()
    expected = _model_arrays(jax_states[1], k)
    got = tck.state_to_jax(tladder.ladder_slice_state(torch_states[1], k))
    assert got[".density.nb_itvs_per_side"] == expected[".density.nb_itvs_per_side"]
    numpy.testing.assert_allclose(got[".density.parameters"], expected[".density.parameters"],
                                  rtol=1e-5, atol=2.6e-6)
    assert not numpy.array_equal(
        got[".density.parameters"], _model_arrays(jax_states[0], k)[".density.parameters"])
    # Nothing else moves in the density phase.
    for key in expected:
        if not key.startswith(".density"):
            numpy.testing.assert_array_equal(got[key], expected[key])


@pytest.mark.parametrize("nb_steps", [1, 2])
@pytest.mark.parametrize("k", range(len(GAMMAS)))
def test_train_steps_match_jax(k, nb_steps):
    (jax_states, torch_states, _) = _trajectories()
    expected = _model_arrays(jax_states[1 + nb_steps], k)
    got = tck.state_to_jax(tladder.ladder_slice_state(torch_states[1 + nb_steps], k))
    assert set(got) == set(expected)
    (nb_far, nb_near, nb_entries) = (0, 0, 0)
    for (key, value) in expected.items():
        if key.startswith(".params"):
            gap = numpy.abs(got[key] - value)
            assert gap.max() <= 2 * csts.LR_EAE * (1 + 1e-4), f"{key}: {gap.max():.3e}"
            nb_far += int(numpy.count_nonzero(gap > 1e-5))
            nb_near += int(numpy.count_nonzero(gap <= 5.0e-6))
            nb_entries += gap.size
        elif ".mu[" in key or ".nu[" in key:
            _assert_close_to_max(got[key], value, 4 * GRAD_RTOL_OF_MAX, key)
        elif key == ".density.parameters":
            numpy.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5)
        elif key == ".bin_widths":
            numpy.testing.assert_array_equal(got[key], value)
        else:  # the counts, the step, the grid's extent
            assert got[key].dtype == value.dtype and got[key] == value, key
    assert nb_far <= 40, f"{nb_far} parameter entries more than 1e-5 apart"
    assert nb_near > 0.9999 * nb_entries, f"{nb_entries - nb_near} entries over 5e-6 apart"
    assert int(got[".step"]) == nb_steps


@pytest.mark.parametrize("k", range(len(GAMMAS)))
def test_free_running_ladder_stays_inside_adams_bound(k):
    (jax_states, _, free) = _trajectories()
    expected = _model_arrays(jax_states[-1], k)
    got = tck.state_to_jax(tladder.ladder_slice_state(free[-1], k))
    for (key, value) in expected.items():
        if key.startswith(".params"):
            gap = float(numpy.abs(got[key] - value).max())
            assert gap <= 2 * 2 * csts.LR_EAE * (1 + 1e-4), f"{key}: {gap:.3e}"
    assert got[".step"] == expected[".step"] == 2
    assert got[".density.nb_itvs_per_side"] == expected[".density.nb_itvs_per_side"]


def test_bin_widths_are_untouched_and_models_diverge():
    (_, _, torch_states) = _trajectories()
    for state in torch_states[1:]:
        assert torch.equal(state.bin_widths, torch_states[0].bin_widths)
    last = torch_states[-1]
    assert not torch.allclose(last.params["weights_1"][0], last.params["weights_1"][1])


@pytest.mark.parametrize("learn_bin_widths", [False, True], ids=["fixed", "learned"])
def test_ladder_equals_sequential_single_models(learn_bin_widths):
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    batches = [_t(_batch(seed)) for seed in (7, 8, 9)]
    if learn_bin_widths:
        # Two learned-bin-width models through the model-axis step, which
        # the ladder's own functions (fixed bin widths) do not reach.
        start = tladder.ladder_stack_states([
            init_train_state(torch.Generator().manual_seed(k), 1.0, True, device="cpu")
            for k in range(len(GAMMAS))])
        stack = ModelAxisStep(GAMMAS, True)
        ladder = stack.training_fct(start, batches[0], _fct_noise(keys[0]))
        for (batch, key) in zip(batches[1:], keys[1:]):
            ladder = stack.train_step(ladder, batch, _step_noise(key))
    else:
        (_, _, torch_states) = _trajectories()
        (start, ladder) = (torch_states[0], torch_states[-1])
    singles = [tladder.ladder_slice_state(start, k) for k in range(len(GAMMAS))]
    single_fns = [make_step_fns(gamma, learn_bin_widths) for gamma in GAMMAS]
    fct_noise = _fct_noise(keys[0])
    singles = [single_fns[k]["training_fct"](singles[k], batches[0], fct_noise[k])
               for k in range(len(GAMMAS))]
    for (batch, key) in zip(batches[1:], keys[1:]):
        noise = _step_noise(key)
        singles = [single_fns[k]["train_step"](singles[k], batch, noise[k])
                   for k in range(len(GAMMAS))]
    # The ladder is one program over the stacked models (grouped convs,
    # the stacked GDN kernel, batched matmuls), so it is held at the JAX
    # package's bounds for its vmapped ladder against single-model runs
    # (tests/test_ladder.py:67-80): an entry whose gradient sits at the
    # numeric noise floor can flip Adam's update, everything else agrees
    # tightly; the density fit's SGD amplifies the same noise.
    for k in range(len(GAMMAS)):
        got = tck.state_to_jax(tladder.ladder_slice_state(ladder, k))
        expected = tck.state_to_jax(singles[k])
        assert set(got) == set(expected)
        for key in expected:
            if key.startswith(".params"):
                diff = numpy.abs(got[key] - expected[key])
                assert diff.max() <= 5.0e-4, (GAMMAS[k], key, diff.max())
                assert (diff <= 2.0e-6).mean() > 0.995, (GAMMAS[k], key)
            elif key == ".density.parameters":
                numpy.testing.assert_allclose(got[key], expected[key], rtol=5e-4, atol=1e-4)
            elif not (".mu[" in key or ".nu[" in key):  # the counts, the extent, bin widths
                numpy.testing.assert_array_equal(got[key], expected[key], err_msg=key)
    if learn_bin_widths:  # the bin widths moved, each model's its own way
        moved = [singles[k].bin_widths for k in range(len(GAMMAS))]
        assert not torch.equal(moved[0], start.bin_widths[0])
        assert not torch.equal(moved[0], moved[1])


def test_train_epoch_is_the_loop_of_train_steps_with_a_generator():
    fns = tladder.make_ladder_step_fns(GAMMAS, max_itvs=32)
    ladder = tladder.init_ladder_state(torch.Generator().manual_seed(1), GAMMAS, max_itvs=32,
                                       device="cpu")
    rng = numpy.random.default_rng(2)
    dataset = _t(rng.integers(16, 236, size=(8, 32, 32, 1)).astype(numpy.uint8))
    rows = rng.permutation(8).reshape(4, 2)
    out = fns["train_epoch"](ladder, dataset, rows, torch.Generator().manual_seed(3))
    generator = torch.Generator().manual_seed(3)
    expected = ladder
    for batch_rows in rows:
        expected = fns["train_step"](expected, dataset[torch.as_tensor(batch_rows)], generator)
    assert torch.equal(out.step, torch.tensor([4, 4], dtype=torch.int32))
    for name in out.params:
        assert torch.equal(out.params[name], expected.params[name])
        assert torch.isfinite(out.params[name]).all()
    assert torch.equal(out.density.parameters, expected.density.parameters)
    with pytest.raises(ValueError, match="noises for 4 batches"):
        fns["train_epoch"](ladder, dataset, rows, [None])
    with pytest.raises(ValueError, match="noises for 2 models"):
        fns["train_step"](ladder, dataset[:2], [None])


def test_stack_and_slice_are_inverses_without_aliasing():
    (_, _, torch_states) = _trajectories()
    ladder = torch_states[-1]
    slices = [tladder.ladder_slice_state(ladder, k, GAMMAS[k]) for k in range(len(GAMMAS))]
    again = tladder.ladder_stack_states(slices)
    map_state(lambda a, b: numpy.testing.assert_array_equal(a.numpy(), b.numpy()), again, ladder)
    # A slice owns its memory: training on after a save cannot change it.
    before = slices[0].params["gamma_1"].clone()
    ladder.params["gamma_1"].add_(1.0)
    assert torch.equal(slices[0].params["gamma_1"], before)
    ladder.params["gamma_1"].sub_(1.0)
    assert slices[1].step.shape == () and slices[1].opt_eae.count.dtype == torch.int32


def test_sliced_checkpoints_load_in_either_package(tmp_path):
    (jax_states, torch_states, _) = _trajectories()
    # Port -> JAX.
    path = os.path.join(tmp_path, "port", "model_1")
    sliced = tladder.ladder_slice_state(torch_states[-1], 1, GAMMAS[1])
    tck.save_checkpoint(path, sliced)
    template = jax_init(jax.random.PRNGKey(0), GAMMAS[1], 1.0, False)
    restored = jck.load_checkpoint(path, template)
    assert int(restored.step) == 2
    numpy.testing.assert_array_equal(numpy.asarray(restored.params["weights_1"]),
                                     tck.params_to_jax(sliced.params)["weights_1"])
    numpy.testing.assert_array_equal(numpy.asarray(restored.opt_eae[0].nu["gamma_3"]),
                                     sliced.opt_eae.nu["gamma_3"].numpy())
    # JAX -> port.
    path = os.path.join(tmp_path, "jax", "model_1")
    jck.save_checkpoint(path, jladder.ladder_slice_state(jax_states[-1], 0, GAMMAS[0]))
    loaded = tck.load_checkpoint(
        path, init_train_state(torch.Generator().manual_seed(0), 1.0, False, device="cpu"))
    expected = _model_arrays(jax_states[-1], 0)
    got = tck.state_to_jax(loaded)
    for key in expected:
        numpy.testing.assert_array_equal(got[key], expected[key], err_msg=key)


def test_ladder_evaluation_matches_jax():
    (jax_states, _, _) = _trajectories()
    key = jax.random.PRNGKey(21)
    (rec_j, ent_j) = jladder.make_ladder_eval_fn(GAMMAS)(jax_states[-1],
                                                         jnp.asarray(_batch(10)), key)
    (rec_t, ent_t) = tladder.make_ladder_eval_fn(GAMMAS)(_carry(jax_states[-1]),
                                                         _t(_batch(10)), _fct_noise(key))
    assert rec_t.shape == (2,) and ent_t.shape == (2,)
    numpy.testing.assert_allclose(rec_t.numpy(), numpy.asarray(rec_j), rtol=1e-5)
    numpy.testing.assert_allclose(ent_t.numpy(), numpy.asarray(ent_j), rtol=1e-5)


@pytest.mark.parametrize("gamma", GAMMAS_DEFAULT)
def test_learning_rate_at_and_around_the_boundaries(gamma):
    """The JAX ladder computes ``LR_EAE * 0.1 ** decays`` in float32
    (``train/ladder.py:86-89``); the port multiplies by 0.1 from each
    boundary on. The two forms agree to the last bit or the one before."""
    boundaries = jcsts.lr_boundaries(gamma)
    assert tuple(boundaries) == tuple(csts.lr_boundaries(gamma))
    for (i, boundary) in enumerate(boundaries):
        for (step, decays) in ((boundary - 1, i), (boundary, i + 1), (boundary + 1, i + 1)):
            expected = jcsts.LR_EAE * jnp.power(0.1, jnp.float32(decays))
            got = learning_rate(gamma, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            numpy.testing.assert_allclose(float(got), float(expected), rtol=1e-6)
