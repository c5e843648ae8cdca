"""PyTorch port: the SVHN side's steps as captured CUDA graphs
(``train/epoch_graph.py``), the counterparts of the JAX package's jitted
steps: the dense EAE's alternation and pre-fit, the VAE's step and the
entropy study's density fit; and the state helpers of
``train/state.py`` on every state kind of the port.

A CUDA graph is captured and replayed only on the card. What runs on the
CPU is the captured body over the static buffers and the device counter
(``EpochProgram.step``), which must equal the eager loop that the
command lines ran before they were routed through the epoch functions,
bit for bit, and one step of which must equal the JAX package's jitted
step within the bounds of ``tests/test_torch_svhn_models.py`` (dense
EAE, VAE) and ``tests/test_torch_svhn_cli.py`` (the entropy study: 1e-3
bits). Small widths as there: 192-32-16, the VAE 192-32-8, ``max_itvs``
32, batches of 10.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import (
    compare_entropy_approximations as jax_entropy_cli,
)
from autoencoder_based_image_compression_tpu.models import dense_eae as jdense
from autoencoder_based_image_compression_tpu.models import vae as jvae
from autoencoder_based_image_compression_tpu.ops import density as jdens
from autoencoder_based_image_compression_tpu.train import checkpoint as jcheckpoint
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.cli import (
    compare_entropy_approximations,
    overfit_svhn,
    train_svhn,
    train_vae,
)
from autoencoder_based_image_compression_tpu_torch.models import dense_eae, vae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.train import checkpoint, epoch_graph, ladder
from autoencoder_based_image_compression_tpu_torch.train.state import (
    clone_state,
    copy_state_into,
    init_train_state,
    map_state,
    state_leaves,
    state_to,
)

WIDTHS = dict(nb_visible=192, nb_hidden=32, nb_y=16)
VAE_WIDTHS = dict(nb_visible=192, nb_hidden=32, nb_z=8)
MAX_ITVS = 32
GAMMA = 1.0
(NB_DIGITS, BATCH, NB_BATCHES) = (40, 10, 3)
FORMS = pytest.mark.parametrize("form", ["generator", "per-batch noise"])


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _arrays(state):
    return {key: numpy.asarray(leaf) for (key, leaf) in jcheckpoint._path_keys(state)}


def _digits(seed, nb=NB_DIGITS, width=WIDTHS["nb_visible"]):
    rng = numpy.random.default_rng(seed)
    return _t(rng.normal(0.0, 1.0, size=(nb, width)).astype(numpy.float32))


def _rows(seed=1):
    order = numpy.random.default_rng(seed).permutation(NB_DIGITS)
    return torch.as_tensor(order[:NB_BATCHES * BATCH].reshape(NB_BATCHES, BATCH))


def _dense(seed=0, learned=True):
    state = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(seed),
                                           max_itvs=MAX_ITVS, device="cpu", **WIDTHS)
    return (state, dense_eae.make_dense_step_fns(GAMMA, learned, MAX_ITVS))


def _vae(seed=0):
    return (vae.init_vae_state(torch.Generator().manual_seed(seed), device="cpu", **VAE_WIDTHS),
            vae.make_vae_step_fn(1.0))


def _run_eagerly(program, state, dataset, rows, noise):
    """The epoch as the loop of the captured step's body over the static
    buffers and the device counter, with its copies in and out."""
    program.load(state, dataset, rows, noise)
    for _ in range(program.nb_batches):
        program.step(program.buffers, program.counter)
    return clone_state(program.buffers)


def _assert_states_equal(got, expected):
    assert type(got) is type(expected)
    for (a, b) in zip(state_leaves(got), state_leaves(expected), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --- The state helpers take every state kind.

def _state_of_kind(kind, seed):
    generator = torch.Generator().manual_seed(seed)
    if kind == "dense":
        return dense_eae.init_dense_eae_state(generator, max_itvs=MAX_ITVS, device="cpu",
                                              **WIDTHS)
    if kind == "vae":
        return vae.init_vae_state(generator, device="cpu", **VAE_WIDTHS)
    if kind == "train":
        return init_train_state(generator, 1.0, True, max_itvs=MAX_ITVS, device="cpu")
    return ladder.init_ladder_state(generator, (10000.0, 24000.0), max_itvs=MAX_ITVS,
                                    device="cpu")


@pytest.mark.parametrize("kind", ["dense", "vae", "train", "ladder"])
def test_state_helpers_take_every_state_kind(kind):
    state = _state_of_kind(kind, 0)
    leaves = state_leaves(state)
    assert all(torch.is_tensor(leaf) for leaf in leaves)
    assert len({id(leaf) for leaf in leaves}) == len(leaves)
    # map_state keeps the structure: the same named tuples and dict keys.
    doubled = map_state(lambda leaf: leaf * 2, state)
    assert type(doubled) is type(state) and doubled._fields == state._fields
    assert list(doubled.params) == list(state.params)
    for (a, b) in zip(state_leaves(doubled), leaves, strict=True):
        assert torch.equal(a, b * 2)
    # A clone shares no storage with its source and equals it.
    clone = clone_state(state)
    _assert_states_equal(clone, state)
    assert not ({leaf.untyped_storage().data_ptr() for leaf in state_leaves(clone)}
                & {leaf.untyped_storage().data_ptr() for leaf in leaves})
    # A copy in place keeps the buffers' storage and takes the values.
    other = _state_of_kind(kind, 1)
    pointers = [leaf.data_ptr() for leaf in state_leaves(clone)]
    assert copy_state_into(clone, other) is clone
    assert [leaf.data_ptr() for leaf in state_leaves(clone)] == pointers
    _assert_states_equal(clone, other)
    assert not torch.equal(state_leaves(clone)[0], leaves[0])
    _assert_states_equal(state_to(state, "cpu"), state)


def test_map_state_takes_other_leaves_at_the_same_places():
    # What parallel.sharding does with its specs: a second state of strings.
    state = _state_of_kind("dense", 0)
    specs = map_state(lambda leaf: "replicated", state)
    assert specs.density.parameters == "replicated" and specs.params["we_l1"] == "replicated"
    shapes = map_state(lambda leaf, spec: (spec, tuple(leaf.shape)), state, specs)
    assert shapes.bin_width == ("replicated", ())


# --- The captured bodies against the eager loops the command lines ran.

def _noise_form(form, per_batch, seed=5):
    return torch.Generator().manual_seed(seed) if form == "generator" else per_batch


def _eps(seed, shape):
    generator = torch.Generator().manual_seed(seed)
    return [dense_eae.uniform_eps(generator, shape, "cpu") for _ in range(NB_BATCHES)]


@FORMS
def test_dense_train_epoch_body_equals_the_alternation_loop(form):
    (state, fns) = _dense()
    (dataset, rows) = (_digits(2), _rows())
    per_batch = _eps(7, (BATCH, WIDTHS["nb_y"]))

    def noise():
        return _noise_form(form, per_batch)

    # The loop of cli/train_svhn before: one eps a batch for both phases.
    expected = state
    source = noise()
    for (i, batch_rows) in enumerate(rows):
        batch = dataset[batch_rows]
        eps = dense_eae.uniform_eps(source if form == "generator" else source[i],
                                    (BATCH, WIDTHS["nb_y"]), "cpu")
        expected = fns["training_eae_bw"](fns["training_fct"](expected, batch, eps), batch, eps)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows, noise())
    _assert_states_equal(_run_eagerly(program, state, dataset, rows, noise()), expected)
    _assert_states_equal(fns["train_epoch"](state, dataset, rows, noise()), expected)
    assert int(expected.step) == NB_BATCHES and int(program.counter) == NB_BATCHES


@FORMS
def test_dense_fit_epoch_body_equals_the_pre_fit_loop(form):
    (state, fns) = _dense()
    dataset = _digits(3)
    rows = epoch_graph.rows_in_order(NB_DIGITS // BATCH, BATCH)
    per_batch = _eps(8, (BATCH, WIDTHS["nb_y"]))[:1] * rows.shape[0]

    def noise():
        return _noise_form(form, per_batch)

    expected = state
    source = noise()
    for j in range(rows.shape[0]):
        batch = dataset[j * BATCH:(j + 1) * BATCH]
        expected = fns["training_fct"](expected, batch,
                                       source if form == "generator" else source[j])
    program = epoch_graph.EpochProgram(fns["training_fct"], state, dataset, rows, noise())
    _assert_states_equal(_run_eagerly(program, state, dataset, rows, noise()), expected)
    _assert_states_equal(fns["fit_epoch"](state, dataset, rows, noise()), expected)
    assert int(expected.step) == 0
    assert not torch.equal(expected.density.parameters, state.density.parameters)


@FORMS
def test_vae_epoch_body_equals_the_step_loop(form):
    (state, step) = _vae()
    (dataset, rows) = (_digits(4), _rows(2))
    generator = torch.Generator().manual_seed(9)
    per_batch = [torch.randn((BATCH, VAE_WIDTHS["nb_z"]), generator=generator)
                 for _ in range(NB_BATCHES)]

    def noise():
        return _noise_form(form, per_batch)

    expected = state
    source = noise()
    for (i, batch_rows) in enumerate(rows):
        expected = step(expected, dataset[batch_rows],
                        source if form == "generator" else source[i])
    program = epoch_graph.EpochProgram(step, state, dataset, rows, noise())
    _assert_states_equal(_run_eagerly(program, state, dataset, rows, noise()), expected)
    _assert_states_equal(vae.make_vae_epoch_fn(1.0)(state, dataset, rows, noise()), expected)
    assert int(expected.step) == NB_BATCHES


def _old_fit_density(samples_noisy, nb_steps):
    """The study's fit as the eager loop it was: the mask made once, the
    samples as they are, ``nb_steps`` SGD steps."""
    (ppi, max_itvs) = (compare_entropy_approximations.PPI, compare_entropy_approximations.MAX_ITVS)
    table = dens.init_density_table(1, ppi, max_itvs, device=samples_noisy.device)
    table = dens.expand_table(table, torch.max(torch.abs(samples_noisy)) + 0.5, ppi, max_itvs)
    mask = dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs)
    parameters = table.parameters
    for _ in range(nb_steps):
        leaf = parameters.detach().requires_grad_(True)
        with torch.enable_grad():
            prob = dens.approximate_probability(samples_noisy[None, :], leaf, ppi, max_itvs)
            loss = dens.loss_density_approximation(prob, leaf, mask, ppi)
        (grads,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            parameters = dens.project_density_parameters(parameters - csts.LR_FCT * grads,
                                                         mask)
    return parameters


def _noisy_samples(seed, nb, delta):
    rng = numpy.random.default_rng(seed)
    samples = rng.laplace(0.0, 1.5, nb).astype(numpy.float32)
    return samples + rng.uniform(-0.5 * delta, 0.5 * delta, nb).astype(numpy.float32)


def test_fit_density_body_equals_the_old_loop_and_matches_jax():
    noisy = _noisy_samples(3, 4000, 0.5)
    samples = _t(noisy)
    expected = _old_fit_density(samples, 60)
    got = compare_entropy_approximations.fit_density(samples, nb_steps=60)
    assert torch.equal(got, expected)
    # The captured body: the table as the state, the samples as a one-row
    # set, row 0 a step, no noise.
    (ppi, max_itvs) = (compare_entropy_approximations.PPI, compare_entropy_approximations.MAX_ITVS)
    table = dens.expand_table(dens.init_density_table(1, ppi, max_itvs),
                              torch.max(torch.abs(samples)) + 0.5, ppi, max_itvs)
    rows = torch.zeros((60, 1), dtype=torch.int64)
    program = epoch_graph.EpochProgram(compare_entropy_approximations._fit_step, table,
                                       samples[None, :], rows, None)
    body = _run_eagerly(program, table, samples[None, :], rows, None)
    assert torch.equal(body.parameters, expected)
    assert torch.equal(body.nb_itvs_per_side, table.nb_itvs_per_side)
    # The JAX study's jitted fit on the same samples: the fitted-pdf
    # entropy within the study test's 1e-3 bits.
    jax_parameters = jax_entropy_cli.fit_density(jnp.asarray(noisy), nb_steps=60)
    fitted = float(dens.differential_entropy(
        dens.approximate_probability(samples[None, :], body.parameters, ppi, max_itvs))[0])
    jax_fitted = float(jdens.differential_entropy(jdens.approximate_probability(
        jnp.asarray(noisy)[None, :], jax_parameters, ppi, max_itvs))[0])
    assert abs(fitted - jax_fitted) <= 1e-3
    numpy.testing.assert_allclose(body.parameters.numpy(), numpy.asarray(jax_parameters),
                                  atol=1e-4)


def test_fit_density_keeps_its_rows_shape_across_fits(monkeypatch):
    # Every fit of the study sends the same rows shape: one capture a
    # sample count on the card. On the CPU each fit is the eager loop.
    seen = []
    run = epoch_graph.epoch_over_rows

    def recording(step, state, dataset, rows, noise):
        seen.append((tuple(dataset.shape), tuple(rows.shape), noise))
        return run(step, state, dataset, rows, noise)

    monkeypatch.setattr(epoch_graph, "epoch_over_rows", recording)
    compare_entropy_approximations.main(["--nb_samples", "500", "--device", "cpu"])
    assert seen == [((1, 500), (400, 1), None)] * 8


# --- One step of a body against the JAX package's jitted step.

def _dense_pair(seed=0, warm_steps=3):
    """A JAX dense state a few alternations old, and the same in the port."""
    state = jdense.init_dense_eae_state(jax.random.PRNGKey(seed), max_itvs=MAX_ITVS, **WIDTHS)
    fns = jdense.make_dense_step_fns(GAMMA, True, MAX_ITVS)
    digits = _digits(100 + seed, nb=BATCH).numpy()
    for i in range(warm_steps):
        key = jax.random.PRNGKey(1000 + i)
        state = fns["training_eae_bw"](fns["training_fct"](state, digits, key), digits, key)
    return (state, checkpoint.dense_state_from_jax(_arrays(state)))


@pytest.mark.parametrize("learned", [True, False], ids=["learned", "fixed"])
def test_one_dense_alternation_of_the_body_matches_jax(learned):
    """``training_fct`` then ``training_eae_bw`` of the JAX package with
    one key against one step of the body with that key's eps: the bounds
    of ``tests/test_torch_svhn_models.py`` (the table within 1e-5, the
    momentum within 1e-4 of its largest entry, weights and bin width
    within 1e-6)."""
    (jax_state, state) = _dense_pair()
    dataset = _digits(6, nb=BATCH)
    rows = epoch_graph.rows_in_order(1, BATCH)
    key = jax.random.PRNGKey(11)
    eps = _t(jax.random.uniform(key, (BATCH, WIDTHS["nb_y"]), jnp.float32, -0.5, 0.5))
    jax_fns = jdense.make_dense_step_fns(GAMMA, learned, MAX_ITVS)
    expected = jax_fns["training_eae_bw"](
        jax_fns["training_fct"](jax_state, dataset.numpy(), key), dataset.numpy(), key)
    fns = dense_eae.make_dense_step_fns(GAMMA, learned, MAX_ITVS)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows, [eps])
    got = _run_eagerly(program, state, dataset, rows, [eps])
    numpy.testing.assert_allclose(got.density.parameters.numpy(),
                                  numpy.asarray(expected.density.parameters), atol=1e-5)
    assert int(got.density.nb_itvs_per_side) == int(expected.density.nb_itvs_per_side)
    for name in state.params:
        momentum = numpy.asarray(expected.momentum[name])
        gap = numpy.abs(got.momentum[name].numpy() - momentum).max()
        assert gap <= 1e-4 * numpy.abs(momentum).max() + 1e-12, f"momentum {name}: {gap:.3e}"
        numpy.testing.assert_allclose(got.params[name].numpy(),
                                      numpy.asarray(expected.params[name]), atol=1e-6,
                                      err_msg=name)
    numpy.testing.assert_allclose(float(got.bin_width), float(expected.bin_width), atol=1e-6)
    assert int(got.step) == int(expected.step) == int(state.step) + 1


def test_one_vae_step_of_the_body_matches_jax():
    jax_state = jvae.init_vae_state(jax.random.PRNGKey(0), **VAE_WIDTHS)
    jax_step = jvae.make_vae_step_fn(1.0)
    dataset = _digits(7, nb=16)
    for i in range(2):
        jax_state = jax_step(jax_state, dataset.numpy(), jax.random.PRNGKey(2000 + i))
    state = checkpoint.vae_state_from_jax(_arrays(jax_state))
    key = jax.random.PRNGKey(6)
    expected = jax_step(jax_state, dataset.numpy(), key)
    epsilon = _t(jax.random.normal(key, (16, VAE_WIDTHS["nb_z"]), jnp.float32))
    rows = epoch_graph.rows_in_order(1, 16)
    program = epoch_graph.EpochProgram(vae.make_vae_step_fn(1.0), state, dataset, rows,
                                       [epsilon])
    got = _run_eagerly(program, state, dataset, rows, [epsilon])
    for name in state.params:
        momentum = numpy.asarray(expected.momentum[name])
        gap = numpy.abs(got.momentum[name].numpy() - momentum).max()
        assert gap <= 1e-4 * numpy.abs(momentum).max() + 1e-12, f"momentum {name}: {gap:.3e}"
        numpy.testing.assert_allclose(got.params[name].numpy(),
                                      numpy.asarray(expected.params[name]), atol=1e-6)
    assert int(got.step) == 3


# --- The epoch functions: the loading, the routing of the command lines.

def test_an_epoch_over_the_same_dataset_skips_its_copy():
    (state, fns) = _dense()
    (dataset, rows) = (_digits(2), _rows())
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows,
                                       torch.Generator())
    program.load(state, dataset, rows, torch.Generator())
    program.dataset.zero_()  # a copy would show
    program.load(state, dataset, rows, torch.Generator())
    assert not program.dataset.any()
    dataset.add_(0.0)  # changed in place: copied again
    program.load(state, dataset, rows, torch.Generator())
    assert torch.equal(program.dataset, dataset)
    program.dataset.zero_()
    program.load(state, dataset.clone(), rows, torch.Generator())  # another tensor
    assert torch.equal(program.dataset, dataset)


def test_train_svhn_routes_its_epochs_through_the_epoch_functions(tmp_path, monkeypatch,
                                                                   capsys):
    seen = []
    make = dense_eae.make_dense_step_fns

    def recording(*args, **kwargs):
        fns = make(*args, **kwargs)
        for name in ("fit_epoch", "train_epoch"):
            def epoch(state, dataset, rows, noise, name=name, run=fns[name]):
                seen.append((name, numpy.asarray(rows)))
                return run(state, dataset, rows, noise)
            fns[name] = epoch
        return fns

    monkeypatch.setattr(dense_eae, "make_dense_step_fns", recording)
    state = train_svhn.main(["1.0", "5.0", "--learn_bin_width", "--synthetic",
                             "--nb_epochs_training", "2", "--batch_size", "500",
                             "--results_root", str(tmp_path), "--device", "cpu"])
    assert [name for (name, _) in seen] == ["fit_epoch", "train_epoch", "train_epoch"]
    numpy.testing.assert_array_equal(seen[0][1], numpy.arange(2000).reshape(4, 500))
    rng = numpy.random.default_rng(0)
    for (_, rows) in seen[1:]:
        numpy.testing.assert_array_equal(rows, rng.permutation(2000).reshape(4, 500))
    assert int(state.step) == 8
    printed = capsys.readouterr().out
    assert "epoch 0: approx-H" in printed and "epoch 1: approx-H" in printed
    assert (tmp_path / "learning_bw" / "1_5" / "model.npz").exists()


def test_overfit_svhn_replays_one_batch_an_epoch(monkeypatch, capsys):
    seen = []
    make = dense_eae.make_dense_step_fns

    def recording(*args, **kwargs):
        fns = make(*args, **kwargs)
        for name in ("fit_epoch", "train_epoch"):
            def epoch(state, dataset, rows, noise, name=name, run=fns[name]):
                seen.append((name, tuple(rows.shape)))
                return run(state, dataset, rows, noise)
            fns[name] = epoch
        return fns

    monkeypatch.setattr(dense_eae, "make_dense_step_fns", recording)
    objectives = overfit_svhn.main(["--nb_epochs", "3", "--nb_examples", "10", "--device",
                                    "cpu"])
    assert seen == [("fit_epoch", (overfit_svhn.NB_FITTING_STEPS, 10))] + [
        ("train_epoch", (1, 10))] * 3
    assert len(objectives) == 2 and "should be decreasing" in capsys.readouterr().out


def test_train_vae_runs_its_epochs_through_the_epoch_function(tmp_path, monkeypatch):
    calls = []
    make = vae.make_vae_epoch_fn

    def recording(*args, **kwargs):
        run = make(*args, **kwargs)

        def epoch(state, dataset, rows, noise):
            calls.append(tuple(rows.shape))
            return run(state, dataset, rows, noise)
        return epoch

    monkeypatch.setattr(vae, "make_vae_epoch_fn", recording)
    losses = train_vae.main(["train", "--nb_epochs_training", "2", "--batch_size", "500",
                             "--results_root", str(tmp_path), "--path_to_training_data",
                             "missing.npy", "--device", "cpu"])
    assert calls == [(4, 500)] * 2 and len(losses) == 2
    assert (tmp_path / "model.npz").exists() and (tmp_path / "model.json").exists()


# --- On the card: the graphed epochs against the eager loops.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured and replayed on the card")


def _gap(got, expected):
    return max(float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-6))
               for (a, b) in zip(state_leaves(got), state_leaves(expected)))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense train", "dense fit", "vae", "fit_density"])
def test_graphed_svhn_step_equals_the_eager_step_on_the_card(path):
    """One graphed step against one eager step from one state with the
    same noise: within 1e-4 of each leaf's largest entry (the density
    gradient's scatter-add sums with atomics on the card)."""
    _card()
    rows = torch.as_tensor([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9]])
    dataset = _digits(2).cuda()
    if path == "vae":
        (state, step) = _vae()
        noise = [torch.randn((BATCH, VAE_WIDTHS["nb_z"]),
                             generator=torch.Generator().manual_seed(3)).cuda()]
        epoch = vae.make_vae_epoch_fn(1.0)
    elif path == "fit_density":
        (state, dataset) = (dens.expand_table(
            dens.init_density_table(1, 4, compare_entropy_approximations.MAX_ITVS),
            torch.tensor(6.0), 4, compare_entropy_approximations.MAX_ITVS),
            _t(_noisy_samples(4, 4000, 0.5))[None, :].cuda())
        (step, noise, rows) = (compare_entropy_approximations._fit_step, None,
                               torch.zeros((1, 1), dtype=torch.int64))
        epoch = epoch_graph.epoch_fn(step)
    else:
        (state, fns) = _dense()
        name = "train" if path == "dense train" else "fit"
        step = fns["train_step" if name == "train" else "training_fct"]
        noise = [_eps(4, (BATCH, WIDTHS["nb_y"]))[0].cuda()]
        epoch = fns[f"{name}_epoch"]
    state = state_to(state, "cuda")
    captures = len(epoch_graph.CAPTURES)
    got = epoch(state, dataset, rows, noise)
    again = epoch(state, dataset, rows, noise)
    expected = epoch_graph.epoch_over_rows(step, state, dataset, rows, noise)
    assert _gap(got, expected) <= 1e-4 and _gap(again, expected) <= 1e-4
    assert len(epoch_graph.CAPTURES) == captures + 1  # the second epoch replays
    assert not {leaf.data_ptr() for leaf in state_leaves(got)} & {
        leaf.data_ptr() for leaf in state_leaves(again)}
