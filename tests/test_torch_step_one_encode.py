"""PyTorch port: a training step encodes its batch once.

The density phase changes only the density table, which the encoder never
reads, so one ``train_step`` encodes the batch once with grad and gives
the density phase the latents detached and the RD loss the same latents.
These tests hold the step, and the eager epoch, to the composition of the
two phases that each encode for themselves (``training_fct`` then
``training_eae_bw``, for one model and for the ladder) bit for bit, on
the CPU at 2 x 32 x 32, with the noise given and drawn from a seeded
generator. They count the encoder's calls (``encode_stacked``: one model
is a stack of one): one a step, one a pre-fit step.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
from autoencoder_based_image_compression_tpu_torch.train import ladder
from autoencoder_based_image_compression_tpu_torch.train import step as tstep
from autoencoder_based_image_compression_tpu_torch.train.state import (
    init_train_state,
    state_leaves,
)

GAMMA = 10000.0
GAMMAS = [10000.0, 40000.0, 96000.0]
PPI = csts.NB_POINTS_PER_INTERVAL
MAX_ITVS = 32
LATENT = (2, 2, 2, 128)
ARCHS = pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
NOISES = pytest.mark.parametrize("given", [True, False], ids=["given", "generator"])


def _batches(seed, count):
    rng = numpy.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, size=(2, 32, 32, 1)).astype(numpy.uint8))
            for _ in range(count)]


def _noise(seed, models=None):
    rng = numpy.random.default_rng(seed)
    shape = LATENT if models is None else (models, *LATENT)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, size=shape).astype(numpy.float32))


def _assert_equal(got, expected):
    (a, b) = (state_leaves(got), state_leaves(expected))
    assert len(a) == len(b)
    for (x, y) in zip(a, b):
        assert torch.equal(x, y)


def _single(learn_bin_widths):
    # A grid of 2 intervals a side: the first step's latents overflow it.
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                             max_itvs=MAX_ITVS, nb_itvs_init=2, device="cpu")
    return (state, tstep.make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS))


def _two_phases(fns):
    def step(state, batch, noise):
        (noise_fct, noise_eae) = ((noise, noise) if isinstance(noise, torch.Generator)
                                  else noise)
        return fns["training_eae_bw"](fns["training_fct"](state, batch, noise_fct), batch,
                                      noise_eae)
    return step


@ARCHS
@NOISES
def test_train_step_equals_the_two_phase_composition(learn_bin_widths, given):
    """Two steps, so that the grid's expansion and a carried state (Adam's
    moments, the grown table) are both covered."""
    (state, fns) = _single(learn_bin_widths)
    (got, expected) = (state, state)
    if given:
        noises = [(_noise(10 + 2 * i), _noise(11 + 2 * i)) for i in range(2)]
        (fed_got, fed_expected) = (noises, noises)
    else:
        (one, other) = (torch.Generator().manual_seed(4), torch.Generator().manual_seed(4))
        (fed_got, fed_expected) = ([one] * 2, [other] * 2)
    for (i, batch) in enumerate(_batches(1, 2)):
        got = fns["train_step"](got, batch, fed_got[i])
        expected = _two_phases(fns)(expected, batch, fed_expected[i])
        _assert_equal(got, expected)
    assert int(state.density.nb_itvs_per_side) < int(got.density.nb_itvs_per_side)
    assert int(got.step) == 2 and int(got.opt_eae.count) == 2
    if learn_bin_widths:
        assert not torch.equal(got.bin_widths, state.bin_widths)


@ARCHS
def test_train_epoch_equals_the_loop_of_the_two_phases(learn_bin_widths):
    (state, fns) = _single(learn_bin_widths)
    dataset = torch.cat(_batches(2, 3))
    rows = numpy.array([[4, 1], [0, 5], [2, 3]], numpy.int32)
    noises = [(_noise(20 + 2 * i), _noise(21 + 2 * i)) for i in range(3)]
    got = fns["train_epoch"](state, dataset, rows, noises)
    expected = state
    for (batch_rows, noise) in zip(rows, noises):
        expected = _two_phases(fns)(expected, dataset[torch.as_tensor(batch_rows)], noise)
    _assert_equal(got, expected)
    assert int(got.step) == 3


def _count_calls(monkeypatch, name):
    calls = []
    original = getattr(conv_eae, name)

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return original(*args, **kwargs)

    monkeypatch.setattr(conv_eae, name, counted)
    return calls


@ARCHS
def test_a_step_encodes_once_and_a_pre_fit_step_once(monkeypatch, learn_bin_widths):
    (state, fns) = _single(learn_bin_widths)
    (batch,) = _batches(3, 1)
    calls = _count_calls(monkeypatch, "encode_stacked")
    fns["train_step"](state, batch, torch.Generator().manual_seed(0))
    assert calls == [True]  # with grad: the RD loss differentiates through it
    del calls[:]
    fns["training_fct"](state, batch, torch.Generator().manual_seed(0))
    assert calls == [False]
    del calls[:]
    fns["training_eae_bw"](state, batch, torch.Generator().manual_seed(0))
    assert calls == [True]


def _ladder():
    start = ladder.init_ladder_state(torch.Generator().manual_seed(1), GAMMAS, max_itvs=MAX_ITVS,
                                     nb_itvs_init=2, device="cpu")
    return (start, tstep.ModelAxisStep(GAMMAS, False, PPI, MAX_ITVS),
            ladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS))


def _ladder_two_phases(whole):
    def step(states, batch, noise):
        if isinstance(noise, torch.Generator):
            (noise_fct, noise_eae) = (noise, noise)
        else:
            (noise_fct, noise_eae) = ([pair[0] for pair in noise], [pair[1] for pair in noise])
        return whole.training_eae_bw(whole.training_fct(states, batch, noise_fct), batch,
                                     noise_eae)
    return step


@NOISES
def test_ladder_train_step_equals_the_two_phase_composition(given):
    (start, whole, fns) = _ladder()
    (got, expected) = (start, start)
    if given:
        noises = [[(_noise(30 + 10 * i + 2 * m), _noise(31 + 10 * i + 2 * m))
                   for m in range(len(GAMMAS))] for i in range(2)]
        (fed_got, fed_expected) = (noises, noises)
    else:
        (one, other) = (torch.Generator().manual_seed(6), torch.Generator().manual_seed(6))
        (fed_got, fed_expected) = ([one] * 2, [other] * 2)
    for (i, batch) in enumerate(_batches(4, 2)):
        got = fns["train_step"](got, batch, fed_got[i])
        expected = _ladder_two_phases(whole)(expected, batch, fed_expected[i])
        _assert_equal(got, expected)
    assert bool((start.density.nb_itvs_per_side < got.density.nb_itvs_per_side).all())
    assert got.step.tolist() == [2] * len(GAMMAS)


def test_ladder_train_epoch_equals_the_loop_of_the_two_phases():
    (start, whole, fns) = _ladder()
    dataset = torch.cat(_batches(5, 3))
    rows = numpy.array([[1, 4], [5, 0], [3, 2]], numpy.int32)
    noises = [[(_noise(40 + 10 * i + 2 * m), _noise(41 + 10 * i + 2 * m))
               for m in range(len(GAMMAS))] for i in range(3)]
    got = fns["train_epoch"](start, dataset, rows, noises)
    expected = start
    for (batch_rows, noise) in zip(rows, noises):
        expected = _ladder_two_phases(whole)(expected, dataset[torch.as_tensor(batch_rows)],
                                             noise)
    _assert_equal(got, expected)


@pytest.mark.parametrize("sharded", [False, True], ids=["stacked", "sharded"])
def test_a_ladder_step_encodes_once_a_block_and_a_pre_fit_step_once(monkeypatch, sharded):
    (start, _, fns) = _ladder()
    if sharded:
        start = ladder.shard_ladder_state(start, make_mesh(1, devices=["cpu"] * len(GAMMAS)))
    blocks = len(GAMMAS) if sharded else 1
    (batch,) = _batches(6, 1)
    calls = _count_calls(monkeypatch, "encode_stacked")
    fns["train_step"](start, batch, torch.Generator().manual_seed(0))
    assert calls == [True] * blocks
    del calls[:]
    fns["training_fct"](start, batch, torch.Generator().manual_seed(0))
    assert calls == [False] * blocks
