"""Training state of the entropy autoencoder, and its Adam.

Everything a training needs sits in one :class:`TrainState`: model
parameters, the density table with its live extent, the bin widths, the
Adam moments and the global step, all tensors on one device. A training
step is a plain function ``(state, batch, noise) -> state`` that builds
new tensors and never asks the host for a value.

Adam is written out as a small functional update over the parameter
dict, with the reference's arithmetic: bias-corrected moments,
``lr * mu_hat / (sqrt(nu_hat) + 1e-8)``, and the learning rate read from
the piecewise-constant schedule at the count *before* the increment.
Weight decay is part of the loss, not of Adam. On the card its leaves
move in one launch of a hand-written kernel
(``ops/kernels/adam_kernel.py``).
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import init_conv_eae_params
from autoencoder_based_image_compression_tpu_torch.ops.kernels.adam_kernel import (
    ADAM_B1,
    ADAM_B2,
    adam_leaves,
)
from autoencoder_based_image_compression_tpu_torch.ops.density import (
    DensityTable,
    init_density_table,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

LR_DECAY = 0.1


class AdamState(NamedTuple):
    """Adam's state: int32 scalar ``count`` of the updates made, first
    moments ``mu`` and second moments ``nu``, dicts like the params."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """Full training state; every leaf is a tensor on one device."""

    params: Dict[str, torch.Tensor]  # conv/GDN parameters (the "eae" parameters)
    density: DensityTable            # piecewise-linear pdf table + live extent
    bin_widths: torch.Tensor         # (nb_maps,) quantisation bin widths
    opt_eae: AdamState               # Adam state of `params`
    step: torch.Tensor               # int32 global step (counts eae updates)


def map_state(fn, *states):
    """``fn`` applied leaf by leaf across states of one structure: the
    state whose every leaf is ``fn(leaf_of_states[0], leaf_of_states[1],
    ...)``.

    The structure is the first state's: named tuples are mapped field by
    field, dicts key by key (in the first state's order), and anything
    else is a leaf. So it takes every state of the port alike: a
    :class:`TrainState`, a stacked ladder state, an SVHN
    ``DenseEaeState`` or ``VaeState``, a ``DensityTable``; and the
    other states may hold other leaves at the same places (the specs
    of ``parallel.sharding``)."""
    first = states[0]
    if isinstance(first, dict):
        return {name: map_state(fn, *[state[name] for state in states]) for name in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(map_state(fn, *[getattr(state, name) for state in states])
                             for name in first._fields))
    return fn(*states)


def state_leaves(state):
    """The state's leaves as one flat list, in the fixed order in which
    :func:`map_state` visits them (the flat view of a state)."""
    leaves = []
    map_state(lambda leaf: leaves.append(leaf) or leaf, state)
    return leaves


def copy_state_into(buffers, state):
    """Copies every leaf of ``state`` into the same leaf of ``buffers``, a
    state of the same shapes and dtypes, in place: one multi-tensor copy a
    dtype (on the card a list of mixed dtypes falls back to one copy a
    leaf). Returns ``buffers``."""
    by_dtype = {}
    for (target, source) in zip(state_leaves(buffers), state_leaves(state)):
        (targets, sources) = by_dtype.setdefault(source.dtype, ([], []))
        targets.append(target)
        sources.append(source)
    for (targets, sources) in by_dtype.values():
        torch._foreach_copy_(targets, sources)
    return buffers


def clone_state(state):
    """A copy of the state that shares no storage with it."""
    return map_state(torch.clone, state)


def state_to(state, device):
    """The state with every leaf moved to ``device``."""
    return map_state(lambda leaf: leaf.to(device), state)


def init_adam(params):
    """Zero moments and a zero count, on the params' device."""
    device = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu={name: torch.zeros_like(value) for (name, value) in params.items()},
                     nu={name: torch.zeros_like(value) for (name, value) in params.items()})


def learning_rate(gamma_scaling, count):
    """Adam's learning rate at ``count`` updates, as a float32 tensor on
    ``count``'s device: ``LR_EAE``, times 0.1 from each of the two
    gamma-keyed boundaries on (``count >= boundary``; reference
    ``EntropyAutoencoder.py:235-243``).

    ``gamma_scaling`` is a number, with a scalar ``count``; or, for M
    models at once (the JAX ladder's ``_lr``, ``train/ladder.py:86-89``),
    an ``(M, 2)`` tensor of each model's boundaries
    (:func:`ladder_boundaries`) with an ``(M,)`` count, giving ``(M,)``
    rates, each what the number form gives for that model.
    """
    if torch.is_tensor(gamma_scaling):
        boundaries = gamma_scaling.unbind(-1)
        shape = count.shape
    else:
        boundaries = csts.lr_boundaries(gamma_scaling)
        shape = ()
    lr = torch.full(shape, csts.LR_EAE, dtype=torch.float32, device=count.device)
    for boundary in boundaries:
        lr = torch.where(count >= boundary, LR_DECAY * lr, lr)
    return lr


def ladder_boundaries(gammas, device):
    """The ``(M, 2)`` float32 tensor of each gamma's learning-rate
    boundaries, on ``device``, for :func:`learning_rate`."""
    return torch.tensor([csts.lr_boundaries(gamma) for gamma in gammas], dtype=torch.float32,
                        device=device)


def current_lr(gamma_scaling, step):
    """Adam's learning rate at a global step, as a Python float (for the
    epoch printout; reference ``training_eae_imagenet.py:199-200``)."""
    lr = csts.LR_EAE
    for boundary in csts.lr_boundaries(gamma_scaling):
        if step >= boundary:
            lr *= LR_DECAY
    return lr


def adam_apply(grads, opt_state, params, lr):
    """One Adam step at the learning rate ``lr``. Returns ``(new_params,
    new_opt_state)``.

    ``mu = 0.9 mu + 0.1 g``; ``nu = 0.999 nu + 0.001 g^2``; both divided
    by ``1 - decay^(count + 1)``; the parameters move by
    ``-lr * mu_hat / (sqrt(nu_hat) + 1e-8)``. ``lr`` is a number, a
    scalar tensor, or for M stacked models an ``(M,)`` tensor, each
    applied to its model's slice of every leaf (as are the corrections
    of an ``(M,)`` count). Every caller goes through this one
    arithmetic: the EAE's scheduled rate (:func:`adam_update`) and the
    hyperprior's constant one (``train/hyperprior.py``). The count and
    the corrections are a few small kernels; on the card every leaf of
    every model then moves in one launch of Adam's kernel, on the CPU
    through the per-leaf chain of its plain twin, bit for bit the same
    (``ops/kernels/adam_kernel.py``).
    """
    count_inc = opt_state.count + 1
    correction_1 = 1.0 - ADAM_B1 ** count_inc.to(torch.float32)
    correction_2 = 1.0 - ADAM_B2 ** count_inc.to(torch.float32)
    names = list(grads)
    updated = adam_leaves([(params[name], grads[name], opt_state.mu[name], opt_state.nu[name])
                           for name in names], lr, correction_1, correction_2)
    (new_params, new_mu, new_nu) = ({}, {}, {})
    for (name, (p, mu, nu)) in zip(names, updated):
        (new_params[name], new_mu[name], new_nu[name]) = (p, mu, nu)
    return (new_params, AdamState(count=count_inc, mu=new_mu, nu=new_nu))


def adam_update(grads, opt_state, params, gamma_scaling):
    """The EAE's Adam step: :func:`adam_apply` at the rate of the
    gamma-keyed schedule read at the count *before* the increment
    (:func:`learning_rate`). For M stacked models, ``gamma_scaling`` is
    their ``(M, 2)`` boundaries and the count, the corrections and the
    rate are ``(M,)``. Returns ``(new_params, new_opt_state)``.
    """
    return adam_apply(grads, opt_state, params, learning_rate(gamma_scaling, opt_state.count))


def init_train_state(generator, bin_width_init=1.0, learn_bin_widths=False,
                     nb_maps=csts.NB_MAPS_3, ppi=csts.NB_POINTS_PER_INTERVAL,
                     max_itvs=csts.MAX_ITVS_PER_SIDE,
                     nb_itvs_init=csts.NB_ITVS_PER_SIDE_INIT, device="cuda"):
    """Fresh training state on ``device`` (the reference's variable
    initialisers). The random parameters are drawn from ``generator`` on
    its own device, so a CPU generator gives the same start on any
    device."""
    device = resolve_device(device)
    params = {name: value.to(device)
              for (name, value) in init_conv_eae_params(generator, learn_bin_widths).items()}
    return TrainState(
        params=params,
        density=init_density_table(nb_maps, ppi, max_itvs, nb_itvs_init, device=device),
        bin_widths=torch.full((nb_maps,), bin_width_init, dtype=torch.float32, device=device),
        opt_eae=init_adam(params),
        step=torch.zeros((), dtype=torch.int32, device=device))
