"""PyTorch port: the training epoch as one captured step replayed
(``train/epoch_graph.py``), the counterpart of the JAX package's scanned
``train_epoch`` (``tests/test_train_epoch_scan.py``).

A CUDA graph is captured and replayed only on the card. What runs on the
CPU is the captured step's body over the static buffers and the device
counter (``EpochProgram.step``), which must equal the eager loop
(``epoch_over_rows``) bit for bit, and one step of which must equal the
JAX package's ``train_step`` within the bounds of
``tests/test_torch_train_step.py``. Small sizes: 32 x 32 crops at batch
2, ``max_itvs=32``, three batches, a ladder of three gammas.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.train import step as jstep
from autoencoder_based_image_compression_tpu.train.checkpoint import _path_keys
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.train import epoch_graph, loop
from autoencoder_based_image_compression_tpu_torch.train import ladder as tladder
from autoencoder_based_image_compression_tpu_torch.train import step as tstep
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    state_from_jax,
    state_to_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    clone_state,
    copy_state_into,
    init_train_state,
    map_state,
    state_leaves,
)

GAMMA = 10000.0
GAMMAS = (10000.0, 24000.0, 72000.0)
MAX_ITVS = 32
LATENT_SHAPE = (2, 2, 2, 128)
MODELS = pytest.mark.parametrize("model", ["learned", "fixed", "ladder"])


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _model(model, seed=0):
    """A fresh state of the model and its step functions, on the CPU."""
    generator = torch.Generator().manual_seed(seed)
    if model == "ladder":
        return (tladder.init_ladder_state(generator, GAMMAS, max_itvs=MAX_ITVS, device="cpu"),
                tladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS))
    learn_bin_widths = model == "learned"
    return (init_train_state(generator, 1.0, learn_bin_widths, max_itvs=MAX_ITVS, device="cpu"),
            tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS))


def _data(seed=1, nb_images=6, nb_batches=3):
    rng = numpy.random.default_rng(seed)
    dataset = _t(rng.integers(0, 256, size=(nb_images, 32, 32, 1)).astype(numpy.uint8))
    rows = rng.permutation(nb_images)[:2 * nb_batches].reshape(nb_batches, 2)
    return (dataset, torch.as_tensor(rows))


def _noises(model, nb_batches, seed=2):
    """One explicit ``train_step`` noise per batch: a (density, autoencoder)
    pair, or a list of pairs, one a ladder model."""
    generator = torch.Generator().manual_seed(seed)

    def pair():
        return tuple(torch.rand(LATENT_SHAPE, generator=generator) - 0.5 for _ in range(2))

    return [[pair() for _ in GAMMAS] if model == "ladder" else pair()
            for _ in range(nb_batches)]


def _run_eagerly(program, state, dataset, rows, noise):
    """The epoch as the loop of the captured step's body over the static
    buffers and the device counter, with its copies in and out."""
    program.load(state, dataset, rows, noise)
    for _ in range(program.nb_batches):
        program.step(program.buffers, program.counter)
    return clone_state(program.buffers)


def _assert_states_equal(got, expected):
    for (a, b) in zip(state_leaves(got), state_leaves(expected), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@MODELS
@pytest.mark.parametrize("form", ["generator", "per-batch noise"])
def test_captured_step_body_equals_the_eager_loop(model, form):
    (state, fns) = _model(model)
    (dataset, rows) = _data()

    def noise():
        return (torch.Generator().manual_seed(5) if form == "generator"
                else _noises(model, rows.shape[0]))

    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows, noise())
    got = _run_eagerly(program, state, dataset, rows, noise())
    expected = tstep.epoch_over_rows(fns["train_step"], state, dataset, rows, noise())
    _assert_states_equal(got, expected)
    assert torch.equal(state.step + 3, got.step)
    assert int(program.counter) == 3


@pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
def test_one_step_of_the_body_matches_jax_train_step(learn_bin_widths):
    """The bounds of ``tests/test_torch_train_step.py`` after one step
    from one state: parameters within 2 lr a entry and 1e-5 in all,
    Adam's moments within 2e-4 of each leaf's largest entry, the density
    table rtol / atol 1e-5, the bin widths rtol 1e-6, the counts equal."""
    jax_fns = jstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    (dataset, rows) = _data(nb_batches=1)
    jax_state = jax_init(jax.random.PRNGKey(0), GAMMA, bin_width_init=1.0,
                         learn_bin_widths=learn_bin_widths, max_itvs=MAX_ITVS)
    jax_state = jax_fns["train_step"](jax_state, jnp.asarray(dataset.numpy()[rows[0].numpy()]),
                                      jax.random.PRNGKey(3))
    state = state_from_jax({key: numpy.asarray(leaf) for (key, leaf) in _path_keys(jax_state)})
    key = jax.random.PRNGKey(9)
    (key_fct, key_eae) = jax.random.split(key)
    noise = tuple(_t(jax.random.uniform(k, LATENT_SHAPE, jnp.float32, -0.5, 0.5))
                  for k in (key_fct, key_eae))
    fns = tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows, [noise])
    got = state_to_jax(_run_eagerly(program, state, dataset, rows, [noise]))
    expected = jax_fns["train_step"](jax_state, jnp.asarray(dataset.numpy()[rows[0].numpy()]),
                                     key)
    expected = {k: numpy.asarray(v) for (k, v) in _path_keys(expected)}
    assert set(got) == set(expected)
    param_gaps = []
    for (name, value) in expected.items():
        if name.startswith(".params"):
            param_gaps.append(float(numpy.abs(got[name] - value).max()))
            assert param_gaps[-1] <= 2 * csts.LR_EAE, name
        elif ".mu[" in name or ".nu[" in name:
            gap = numpy.abs(got[name].astype(numpy.float64) - value).max()
            assert gap <= 2e-4 * numpy.abs(value).max() + 1e-12, name
        elif name == ".density.parameters":
            numpy.testing.assert_allclose(got[name], value, rtol=1e-5, atol=1e-5)
        elif name == ".bin_widths":
            numpy.testing.assert_allclose(got[name], value, rtol=1e-6)
        else:  # the counts, the step, the grid's extent
            assert got[name].dtype == value.dtype and got[name] == value, name
    assert int(got[".step"]) == 2 and max(param_gaps) <= 1e-5


def test_returned_state_shares_no_storage_and_survives_the_next_epoch():
    (state, fns) = _model("learned")
    (dataset, rows) = _data()
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset, rows,
                                       torch.Generator().manual_seed(5))
    first = _run_eagerly(program, state, dataset, rows, None)
    kept = clone_state(first)
    storages = {leaf.untyped_storage().data_ptr()
                for leaf in state_leaves(program.buffers) + state_leaves(state)}
    assert not storages & {leaf.untyped_storage().data_ptr() for leaf in state_leaves(first)}
    second = _run_eagerly(program, first, dataset, rows, None)
    _assert_states_equal(first, kept)
    assert int(second.step) == 6 and int(first.step) == 3 and int(state.step) == 0


def test_flat_view_copies_in_place_and_clones_apart():
    (state, _) = _model("fixed")
    leaves = state_leaves(state)
    # params, Adam's two moments of each, the table, its extent, the bin
    # widths, Adam's count and the step: every leaf once, in a fixed order.
    assert len(leaves) == 3 * len(state.params) + 5
    assert len({id(leaf) for leaf in leaves}) == len(leaves)
    assert [leaf.shape for leaf in state_leaves(clone_state(state))] == [
        leaf.shape for leaf in leaves]
    buffers = clone_state(state)
    pointers = [leaf.data_ptr() for leaf in state_leaves(buffers)]
    other = init_train_state(torch.Generator().manual_seed(3), 1.0, False, max_itvs=MAX_ITVS,
                             device="cpu")
    assert copy_state_into(buffers, other) is buffers
    assert [leaf.data_ptr() for leaf in state_leaves(buffers)] == pointers
    _assert_states_equal(buffers, other)
    assert not torch.equal(buffers.params["weights_1"], state.params["weights_1"])


@MODELS
def test_train_epoch_on_a_cpu_state_is_the_eager_loop(model, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU state reached the graphed epoch")

    monkeypatch.setattr(epoch_graph.GraphedEpoch, "__call__", refuse)
    (state, fns) = _model(model)
    (dataset, rows) = _data()
    got = fns["train_epoch"](state, dataset, rows.numpy(), _noises(model, rows.shape[0]))
    expected = tstep.epoch_over_rows(fns["train_step"], state, dataset, rows,
                                     _noises(model, rows.shape[0]))
    _assert_states_equal(got, expected)
    with pytest.raises(ValueError, match="2 noises for 3 batches"):
        fns["train_epoch"](state, dataset, rows, _noises(model, 2))


def test_graphed_epoch_refuses_a_dataset_off_the_card():
    (state, fns) = _model("learned")
    (dataset, rows) = _data()
    with pytest.raises(RuntimeError, match="on the card"):
        epoch_graph.GraphedEpoch(fns["train_step"])(state, dataset, rows,
                                                    torch.Generator().manual_seed(0))


@pytest.mark.parametrize("model", ["learned", "ladder"])
def test_run_epoch_training_routes_through_train_epoch(model):
    """As ``tests/test_train_epoch_scan.py`` asserts for the JAX package."""
    (state, fns) = _model(model)
    (dataset, _) = _data()
    seen = []
    train_epoch = fns["train_epoch"]

    def recording(*args):
        seen.append(args)
        return train_epoch(*args)

    out = loop.run_epoch_training(dataset, state, {**fns, "train_epoch": recording}, 2, 3,
                                  torch.Generator().manual_seed(4),
                                  permutation=numpy.array([5, 0, 4, 1, 3, 2]))
    assert len(seen) == 1
    (_, _, rows, _) = seen[0]
    numpy.testing.assert_array_equal(rows, [[5, 0], [4, 1], [3, 2]])
    assert torch.equal(out.step, state.step + 3)
    assert all(bool(torch.isfinite(leaf.double()).all()) for leaf in state_leaves(out))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured and replayed on the card")


@pytest.mark.cuda
@MODELS
def test_graphed_epoch_equals_the_eager_loop_on_the_card(model):
    """One graphed step against one eager step from one state with the
    same per-batch noise: within 1e-4 of each leaf's largest entry (the
    JAX scan test's bound; cuDNN sums with atomics on the card)."""
    _card()
    (state, fns) = _model(model)
    state = map_state(lambda leaf: leaf.cuda(), state)
    (dataset, rows) = _data()
    (dataset, rows) = (dataset.cuda(), rows[:1])
    noise = [tuple(n.cuda() for n in pair) if model != "ladder"
             else [tuple(n.cuda() for n in p) for p in pair]
             for pair in _noises(model, 1)]
    got = fns["train_epoch"](state, dataset, rows, noise)
    expected = tstep.epoch_over_rows(fns["train_step"], state, dataset, rows, noise)
    for (a, b) in zip(state_leaves(got), state_leaves(expected)):
        (a, b) = (a.double(), b.double())
        assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max()) + 1e-6)
    again = fns["train_epoch"](state, dataset, rows, noise)
    assert not set(leaf.data_ptr() for leaf in state_leaves(got)) & set(
        leaf.data_ptr() for leaf in state_leaves(again))


@pytest.mark.cuda
def test_capture_refuses_cudnn_deterministic():
    _card()
    from autoencoder_based_image_compression_tpu_torch.utils.device import deterministic_cudnn

    (state, fns) = _model("learned")
    state = map_state(lambda leaf: leaf.cuda(), state)
    (dataset, rows) = _data()
    with deterministic_cudnn(), pytest.raises(RuntimeError, match="deterministic"):
        fns["train_epoch"](state, dataset.cuda(), rows, torch.Generator("cuda").manual_seed(0))
