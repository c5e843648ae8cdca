"""PyTorch port: the Kodak density pre-fit as a captured CUDA graph
(``fit_epoch`` of ``train/step.py::make_step_fns`` and
``train/ladder.py::make_ladder_step_fns``, driven by
``train/loop.py::preliminary_fitting``), the counterpart of the JAX
package's jitted ``training_fct`` (``train/step.py:186-188``, driven by
``train/loop.py:83-97``).

On the CPU the captured body (``EpochProgram.step`` over the static
buffers) must equal the pre-fit loop as it was (``training_fct`` on each
slice of the set in order) bit for bit, for both architectures and a
3-gamma ladder; one step of it must equal the JAX package's
``training_fct`` within the bounds of ``tests/test_torch_train_step.py``
(the table rtol / atol 1e-5, the grid's extent equal), a ladder model
against the JAX ``training_fct`` of its own state with its own key. Small
sizes: 32 x 32 crops at batch 2, ``max_itvs=32``, three batches.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.train import step as jstep
from autoencoder_based_image_compression_tpu.train.checkpoint import _path_keys
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
from autoencoder_based_image_compression_tpu_torch.train import epoch_graph, loop
from autoencoder_based_image_compression_tpu_torch.train import ladder as tladder
from autoencoder_based_image_compression_tpu_torch.train import step as tstep
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import state_from_jax
from autoencoder_based_image_compression_tpu_torch.train.state import (
    clone_state,
    init_train_state,
    state_leaves,
    state_to,
)

GAMMA = 10000.0
GAMMAS = (10000.0, 24000.0, 72000.0)
MAX_ITVS = 32
LATENT_SHAPE = (2, 2, 2, 128)
(NB_IMAGES, BATCH) = (6, 2)
MODELS = pytest.mark.parametrize("model", ["learned", "fixed", "ladder"])


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _model(model, seed=0):
    generator = torch.Generator().manual_seed(seed)
    if model == "ladder":
        return (tladder.init_ladder_state(generator, GAMMAS, max_itvs=MAX_ITVS, device="cpu"),
                tladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS))
    learn_bin_widths = model == "learned"
    return (init_train_state(generator, 1.0, learn_bin_widths, max_itvs=MAX_ITVS, device="cpu"),
            tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS))


def _dataset(seed=1):
    rng = numpy.random.default_rng(seed)
    return _t(rng.integers(0, 256, size=(NB_IMAGES, 32, 32, 1)).astype(numpy.uint8))


def _noises(model, nb_batches, seed=2):
    """One explicit ``training_fct`` noise per batch: a tensor, or a list
    of them, one a ladder model."""
    generator = torch.Generator().manual_seed(seed)

    def draw():
        return torch.rand(LATENT_SHAPE, generator=generator) - 0.5

    return [[draw() for _ in GAMMAS] if model == "ladder" else draw()
            for _ in range(nb_batches)]


def _run_eagerly(program, state, dataset, rows, noise):
    program.load(state, dataset, rows, noise)
    for _ in range(program.nb_batches):
        program.step(program.buffers, program.counter)
    return clone_state(program.buffers)


def _assert_states_equal(got, expected):
    for (a, b) in zip(state_leaves(got), state_leaves(expected), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _slices_loop(fns, state, dataset, noise):
    """The pre-fit epoch as ``preliminary_fitting`` ran it before: the
    slices of the set in order."""
    for j in range(NB_IMAGES // BATCH):
        step_noise = noise if isinstance(noise, torch.Generator) else noise[j]
        state = fns["training_fct"](state, dataset[j * BATCH:(j + 1) * BATCH], step_noise)
    return state


@MODELS
@pytest.mark.parametrize("form", ["generator", "per-batch noise"])
def test_fit_epoch_body_equals_the_pre_fit_loop(model, form):
    (state, fns) = _model(model)
    dataset = _dataset()
    rows = epoch_graph.rows_in_order(NB_IMAGES // BATCH, BATCH)

    def noise():
        return (torch.Generator().manual_seed(5) if form == "generator"
                else _noises(model, rows.shape[0]))

    expected = _slices_loop(fns, state, dataset, noise())
    program = epoch_graph.EpochProgram(fns["training_fct"], state, dataset, rows, noise())
    _assert_states_equal(_run_eagerly(program, state, dataset, rows, noise()), expected)
    _assert_states_equal(fns["fit_epoch"](state, dataset, rows, noise()), expected)
    # The pre-fit moves the density alone.
    assert torch.equal(expected.step, state.step)
    assert not torch.equal(expected.density.parameters, state.density.parameters)


@pytest.mark.parametrize("model", ["learned", "ladder"])
def test_preliminary_fitting_routes_through_fit_epoch(model):
    (state, fns) = _model(model)
    dataset = _dataset()
    seen = []
    fit_epoch = fns["fit_epoch"]

    def recording(*args):
        seen.append(args)
        return fit_epoch(*args)

    got = loop.preliminary_fitting(dataset.numpy(), state, {**fns, "fit_epoch": recording},
                                   BATCH, 2, torch.Generator().manual_seed(4))
    assert len(seen) == 2
    for (_, _, rows, _) in seen:
        numpy.testing.assert_array_equal(rows, [[0, 1], [2, 3], [4, 5]])
    generator = torch.Generator().manual_seed(4)
    expected = _slices_loop(fns, _slices_loop(fns, state, dataset, generator), dataset,
                            generator)
    _assert_states_equal(got, expected)


@MODELS
def test_one_step_of_the_fit_body_matches_jax_training_fct(model):
    """From one state a ``train_step`` old, with the noise the JAX
    ``training_fct`` draws from its key (a ladder model: its own state
    and key): the table within rtol / atol 1e-5, the grid's extent equal,
    nothing else moved."""
    learn_bin_widths = model == "learned"
    gammas = GAMMAS if model == "ladder" else (GAMMA,)
    dataset = _dataset()
    rows = epoch_graph.rows_in_order(1, BATCH)
    batch = jnp.asarray(dataset.numpy()[:BATCH])
    (jax_states, states, noises, expected) = ([], [], [], [])
    for (k, gamma) in enumerate(gammas):
        jax_fns = jstep.make_step_fns(gamma, learn_bin_widths, max_itvs=MAX_ITVS)
        jax_state = jax_init(jax.random.PRNGKey(k), gamma, bin_width_init=1.0,
                             learn_bin_widths=learn_bin_widths, max_itvs=MAX_ITVS)
        jax_state = jax_fns["train_step"](jax_state, batch, jax.random.PRNGKey(5 + k))
        jax_states.append(jax_state)
        states.append(state_from_jax({key: numpy.asarray(leaf)
                                      for (key, leaf) in _path_keys(jax_state)}))
        key = jax.random.PRNGKey(20 + k)
        noises.append(_t(jax.random.uniform(key, LATENT_SHAPE, jnp.float32, -0.5, 0.5)))
        expected.append(jax_fns["training_fct"](jax_state, batch, key))
    if model == "ladder":
        (state, fns, noise) = (tladder.ladder_stack_states(states),
                               tladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS), noises)
    else:
        (state, fns, noise) = (states[0], tstep.make_step_fns(GAMMA, learn_bin_widths,
                                                               max_itvs=MAX_ITVS), noises[0])
    program = epoch_graph.EpochProgram(fns["training_fct"], state, dataset, rows, [noise])
    got = _run_eagerly(program, state, dataset, rows, [noise])
    for (k, want) in enumerate(expected):
        (table, extent) = ((got.density.parameters[k], got.density.nb_itvs_per_side[k])
                           if model == "ladder" else
                           (got.density.parameters, got.density.nb_itvs_per_side))
        assert int(extent) == int(want.density.nb_itvs_per_side)
        numpy.testing.assert_allclose(table.numpy(), numpy.asarray(want.density.parameters),
                                      rtol=1e-5, atol=1e-5)
    for name in state.params:
        assert torch.equal(got.params[name], state.params[name])
    assert torch.equal(got.step, state.step) and torch.equal(got.bin_widths, state.bin_widths)


def test_sharded_ladder_fit_epoch_runs_block_by_block():
    """A sharded ladder's ``fit_epoch``: each block's whole pre-fit with
    its own models' noise, equal to the unsharded ladder's (rtol 1e-6 /
    atol 1e-7, the sharded step's bound); with a generator, block after
    block."""
    (start, fns) = _model("ladder", seed=2)
    dataset = _dataset(9)
    rows = epoch_graph.rows_in_order(NB_IMAGES // BATCH, BATCH)
    noise = _noises("ladder", rows.shape[0], seed=7)
    plain = fns["fit_epoch"](start, dataset, rows, noise)
    mesh = make_mesh(1, devices=["cpu"] * len(GAMMAS))
    sharded = fns["fit_epoch"](tladder.shard_ladder_state(start, mesh), dataset, rows, noise)
    assert isinstance(sharded, tladder.LadderShards)
    for (a, b) in zip(state_leaves(sharded.fetch()), state_leaves(plain)):
        numpy.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    shards = tladder.shard_ladder_state(start, mesh)
    got = fns["fit_epoch"](shards, dataset, rows, torch.Generator().manual_seed(4)).fetch()
    generator = torch.Generator().manual_seed(4)
    blocks = {}
    for m in range(len(GAMMAS)):
        one = tladder.make_ladder_step_fns(GAMMAS[m:m + 1], max_itvs=MAX_ITVS)
        blocks[m] = _slices_loop(one, shards.blocks[m], dataset, generator)
    expected = tladder.LadderShards(mesh, "data", len(GAMMAS), blocks).fetch()
    _assert_states_equal(got, expected)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured and replayed on the card")


@pytest.mark.cuda
@MODELS
def test_graphed_fit_epoch_equals_the_eager_loop_on_the_card(model):
    """One graphed pre-fit step against one eager step from one state
    with the same noise: within 1e-4 of each leaf's largest entry (the
    density gradient's scatter-add sums with atomics); a second epoch
    replays the first one's capture."""
    _card()
    (state, fns) = _model(model)
    state = state_to(state, "cuda")
    dataset = _dataset().cuda()
    rows = epoch_graph.rows_in_order(1, BATCH)
    noise = [[n.cuda() for n in pair] if model == "ladder" else pair.cuda()
             for pair in _noises(model, 1)]
    captures = len(epoch_graph.CAPTURES)
    got = fns["fit_epoch"](state, dataset, rows, noise)
    fns["fit_epoch"](state, dataset, rows, noise)
    expected = epoch_graph.epoch_over_rows(fns["training_fct"], state, dataset, rows, noise)
    for (a, b) in zip(state_leaves(got), state_leaves(expected)):
        (a, b) = (a.double(), b.double())
        assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max()) + 1e-6)
    assert len(epoch_graph.CAPTURES) == captures + 1
