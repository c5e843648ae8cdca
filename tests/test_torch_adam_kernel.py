"""Adam's fused kernel (``ops/kernels/adam_kernel.py``, ``csrc/adam.cu``).

On the CPU: the launch plan puts every element of every leaf in exactly
one block's chunk, no chunk crosses a model's slice, and more than 32
leaves take another launch; ``train.state.adam_apply`` on CPU tensors
equals the per-leaf chain it ran before the kernel, bit for bit. The
``cuda``-marked tests hold the kernel against the per-leaf chain with
``torch.equal`` on every output: one model's 19 and 23 leaves, seven
stacked models whose counts straddle their learning-rate boundaries, the
scale hyperprior's vector at its constant rate, ragged leaves; and its
refusals. Imports no JAX, so that the card's machine runs this file
(``-m cuda --noconftest``).
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import collections
import contextlib

import pytest
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.cli.train_ladder import GAMMAS_DEFAULT
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import init_conv_eae_params
from autoencoder_based_image_compression_tpu_torch.ops.kernels import adam_kernel
from autoencoder_based_image_compression_tpu_torch.ops.kernels.adam_kernel import (
    CHUNK,
    MAX_LEAVES,
    adam_leaves,
    adam_leaves_plain,
    launch_plan,
)
from autoencoder_based_image_compression_tpu_torch.train import hyperprior
from autoencoder_based_image_compression_tpu_torch.train.state import (
    AdamState,
    adam_apply,
    ladder_boundaries,
    learning_rate,
)

GAMMAS = GAMMAS_DEFAULT  # the ladder's seven gammas; their boundaries differ
HYPERPRIOR_VECTOR = 5073539  # the hyperprior's parameters laid end to end, unpadded


def _eae_shapes(learn_bin_widths):
    params = init_conv_eae_params(torch.Generator().manual_seed(0), learn_bin_widths)
    return [tuple(value.shape) for value in params.values()]


def block_chunks(sizes, entries, blocks):
    """``(leaf, model, start, stop)`` of each block of a launch: the
    elements ``[start, stop)`` of model ``model``'s slice of leaf
    ``leaf``, found as ``csrc/adam.cu``'s kernel finds them (the last
    leaf whose first block is at most the block's index)."""
    for block in range(blocks):
        i = 0
        while i + 1 < len(entries) and entries[i + 1][2] <= block:
            i += 1
        (leaf, per_model, first) = entries[i]
        (model, chunk) = divmod(block - first, per_model)
        yield (leaf, model, chunk * CHUNK, min((chunk + 1) * CHUNK, sizes[leaf]))


def _count(sizes, models):
    return sum(1 for (entries, blocks) in launch_plan(sizes, models))


# Leaf sizes (elements a model) and models: one model's 19 and 23 leaves, the
# seven-model ladder's, the hyperprior's vector (padded and not), ragged
# leaves and more leaves than a launch holds.
PLANS = {
    "one model, learned": ([int(torch.Size(s).numel()) for s in _eae_shapes(True)], 1),
    "one model, fixed": ([int(torch.Size(s).numel()) for s in _eae_shapes(False)], 1),
    "ladder": ([int(torch.Size(s).numel()) for s in _eae_shapes(False)], 7),
    "hyperprior": ([hyperprior.SIZE], 1),
    "hyperprior, unpadded": ([HYPERPRIOR_VECTOR], 1),
    "ragged": ([1, 3, 4097, 0, CHUNK, CHUNK + 1], 3),
    "40 leaves": ([(7 * i) % 9000 + 1 for i in range(40)], 2),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_the_plan_covers_every_element_once_within_a_models_slice(case):
    (sizes, models) = PLANS[case]
    seen = collections.defaultdict(list)
    for (entries, blocks) in launch_plan(sizes, [models] * len(sizes)):
        assert 0 < len(entries) <= MAX_LEAVES
        assert blocks == sum(per_model * models for (_, per_model, _) in entries)
        for (leaf, model, start, stop) in block_chunks(sizes, entries, blocks):
            assert 0 <= model < models
            # Inside one model's slice: the rate and corrections of a block are one.
            assert 0 <= start < stop <= sizes[leaf] and stop - start <= CHUNK
            seen[(leaf, model)].append((start, stop))
    for (leaf, size) in enumerate(sizes):
        for model in range(models):
            chunks = sorted(seen.pop((leaf, model), []))
            # Exactly once: the chunks tile [0, size) end to end.
            edges = [0] + [stop for (_, stop) in chunks]
            assert [start for (start, _) in chunks] == edges[:-1] and edges[-1] == size
    assert not seen


@pytest.mark.parametrize("leaves,launches", [(1, 1), (19, 1), (32, 1), (33, 2), (40, 2),
                                             (64, 2), (65, 3)])
def test_more_than_32_leaves_take_another_launch(leaves, launches):
    assert _count([5] * leaves, [1] * leaves) == launches
    # A leaf with no element takes no slot.
    assert _count([5] * leaves + [0] * 40, [1] * (leaves + 40)) == launches


def _old_adam_apply(grads, opt_state, params, lr):
    """``adam_apply`` as it was before the kernel: the per-leaf chain."""
    count_inc = opt_state.count + 1
    correction_1 = 1.0 - 0.9 ** count_inc.to(torch.float32)
    correction_2 = 1.0 - 0.999 ** count_inc.to(torch.float32)

    def per_model(value, leaf):
        if not torch.is_tensor(value):
            return value
        return value.reshape(value.shape + (1,) * (leaf.dim() - value.dim()))

    (new_params, new_mu, new_nu) = ({}, {}, {})
    for (name, grad) in grads.items():
        mu = (1 - 0.9) * grad + 0.9 * opt_state.mu[name]
        nu = (1 - 0.999) * torch.square(grad) + 0.999 * opt_state.nu[name]
        update = (mu / per_model(correction_1, grad)) / (
            torch.sqrt(nu / per_model(correction_2, grad)) + 1e-8)
        new_params[name] = params[name] - per_model(lr, grad) * update
        (new_mu[name], new_nu[name]) = (mu, nu)
    return (new_params, AdamState(count=count_inc, mu=new_mu, nu=new_nu))


def _step_inputs(shapes, count, seed, device="cpu"):
    """``(grads, opt_state, params)`` over leaves of ``shapes`` with Adam's
    count ``count`` (a tensor) and moments a few steps old."""
    generator = torch.Generator().manual_seed(seed)

    def draw(shape, scale, positive=False):
        value = scale * torch.randn(shape, generator=generator)
        return (value.abs() if positive else value).to(device)

    names = [f"leaf_{i}" for i in range(len(shapes))]
    grads = {name: draw(shape, 1e-3) for (name, shape) in zip(names, shapes)}
    params = {name: draw(shape, 0.05) for (name, shape) in zip(names, shapes)}
    state = AdamState(count=count.to(device),
                      mu={name: draw(shape, 1e-4) for (name, shape) in zip(names, shapes)},
                      nu={name: draw(shape, 1e-7, True) for (name, shape) in zip(names, shapes)})
    return (grads, state, params)


def _ladder_counts(models):
    """Counts that put the models on both sides of their boundaries (and
    at the start, where the corrections are far from 1)."""
    counts = []
    for (m, gamma) in enumerate(GAMMAS[:models]):
        (first, second) = csts.lr_boundaries(gamma)
        counts.append((0, 5, first - 1, first, second - 1, second, second + 7)[m % 7])
    return torch.tensor(counts, dtype=torch.int32)


def _cases():
    """``(name, shapes, count, lr)``: the three cells' leaf sets and ragged
    leaves; ``lr`` None for the EAE's schedule read at the count."""
    one = torch.tensor([3], dtype=torch.int32)
    ladder = [(7,) + shape for shape in _eae_shapes(False)]
    return [
        ("one model, learned", [(1,) + s for s in _eae_shapes(True)], one, None),
        ("one model, fixed", [(1,) + s for s in _eae_shapes(False)], one, None),
        ("ladder, rates apart", ladder, _ladder_counts(7), None),
        ("hyperprior", [(hyperprior.SIZE,)], torch.tensor(4, dtype=torch.int32), hyperprior.LR),
        ("hyperprior, unpadded", [(HYPERPRIOR_VECTOR,)], torch.tensor(0, dtype=torch.int32),
         hyperprior.LR),
        ("ragged", [(1,), (3,), (4097,)], torch.tensor(9, dtype=torch.int32), 1e-3),
        ("ragged, three models", [(3, 1), (3, 3), (3, 4097)], torch.tensor([0, 1, 1500000],
                                                                          dtype=torch.int32),
         None),
        ("40 leaves", [(1, 5 * i + 1) for i in range(40)], one, None),
    ]


def _rate(count, lr, models):
    if lr is not None:
        return lr
    gammas = GAMMAS[:models] if count.dim() else GAMMAS[:1]
    return learning_rate(ladder_boundaries(gammas, count.device), count)


def _assert_equal(got, expected):
    (params, state) = got
    (params_0, state_0) = expected
    assert torch.equal(state.count, state_0.count)
    for name in params_0:
        for (a, b) in ((params, params_0), (state.mu, state_0.mu), (state.nu, state_0.nu)):
            assert a[name].shape == b[name].shape and torch.equal(a[name], b[name]), name


@contextlib.contextmanager
def _one_thread():
    """PyTorch's CPU ops on the calling thread alone. With other test
    processes on the same cores, an intra-op worker thread was seen to
    round its chunk of an elementwise op a unit in the last place apart
    from the calling thread, in the first of two equal computations: the
    CPU runtime, not the code under test. The bit-for-bit comparisons of
    two CPU chains run without worker threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", [case[0] for case in _cases() if "hyperprior" not in case[0]])
def test_adam_apply_on_the_cpu_is_the_per_leaf_chain(case):
    (_, shapes, count, lr) = next(c for c in _cases() if c[0] == case)
    (grads, state, params) = _step_inputs(shapes, count, 7)
    rate = _rate(count, lr, count.shape[0] if count.dim() else 1)
    with _one_thread():
        _assert_equal(adam_apply(grads, state, params, rate),
                      _old_adam_apply(grads, state, params, rate))


def test_the_hyperprior_steps_vector_on_the_cpu_is_the_chain():
    vector = [(HYPERPRIOR_VECTOR,)]
    (grads, state, params) = _step_inputs(vector, torch.tensor(2, dtype=torch.int32), 8)
    with _one_thread():
        _assert_equal(adam_apply(grads, state, params, hyperprior.LR),
                      _old_adam_apply(grads, state, params, hyperprior.LR))


def test_cpu_leaves_never_reach_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(adam_kernel, "load_library", refuse)
    leaves = [tuple(torch.ones(4) for _ in range(4))]
    adam_kernel.reset_launch_counts()
    assert len(adam_leaves(leaves, 1e-3, torch.tensor(0.1), torch.tensor(1e-3))) == 1
    assert adam_kernel.LAUNCHES["adam_f32"] == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [case[0] for case in _cases()])
def test_cuda_kernel_equals_the_plain_chain_bit_for_bit(case):
    """Every parameter and both moments of every leaf through
    ``adam_apply``, ``torch.equal`` to the per-leaf chain on the card; one
    launch for up to 32 leaves, counted at its ``(leaves, models)``."""
    _cuda()
    (_, shapes, count, lr) = next(c for c in _cases() if c[0] == case)
    (grads, state, params) = _step_inputs(shapes, count, 21, "cuda")
    models = count.shape[0] if count.dim() else 1
    rate = _rate(state.count, lr, models)
    if case == "ladder, rates apart":
        assert len(set(rate.tolist())) == 3
    adam_kernel.reset_launch_counts()
    got = adam_apply(grads, state, params, rate)
    torch.cuda.synchronize()
    launches = -(-len(shapes) // MAX_LEAVES)
    assert adam_kernel.LAUNCHES["adam_f32"] == launches
    assert sum(adam_kernel.LAUNCH_SHAPES.values()) == launches
    assert adam_kernel.LAUNCH_SHAPES[(min(len(shapes), MAX_LEAVES), models)] >= 1
    _assert_equal(got, _old_adam_apply(grads, state, params, rate))


@pytest.mark.cuda
def test_cuda_kernel_at_an_unaligned_slice():
    """Views that start off a 16-byte boundary take the scalar path."""
    _cuda()
    (grads, state, params) = _step_inputs([(4099,)], torch.tensor(3, dtype=torch.int32), 22,
                                          "cuda")
    leaves = [(params["leaf_0"][1:], grads["leaf_0"][1:], state.mu["leaf_0"][1:],
               state.nu["leaf_0"][1:])]
    values = (2e-4, torch.tensor(0.3, device="cuda"), torch.tensor(0.004, device="cuda"))
    for (a, b) in zip(adam_leaves(leaves, *values)[0], adam_leaves_plain(leaves, *values)[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_cannot_read():
    _cuda()
    leaf = tuple(torch.ones((3, 8), device="cuda") for _ in range(4))
    values = (1e-3, torch.full((3,), 0.1, device="cuda"), torch.full((3,), 1e-3, device="cuda"))
    with pytest.raises(TypeError, match="fp32"):
        adam_leaves([(leaf[0].double(),) + leaf[1:]], *values)
    with pytest.raises(ValueError, match="C-contiguous"):
        adam_leaves([(leaf[0],) + tuple(t.t().contiguous().t() for t in leaf[1:])], *values)
    with pytest.raises(ValueError, match="shape"):
        adam_leaves([leaf[:3] + (torch.ones((3, 9), device="cuda"),)], *values)
    with pytest.raises(ValueError, match="leading axis"):
        adam_leaves([tuple(t.t().contiguous() for t in leaf)], *values)
    with pytest.raises(ValueError, match="on cpu"):
        adam_leaves([leaf[:3] + (leaf[3].cpu(),)], *values)
