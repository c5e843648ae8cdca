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
Weight decay is part of the loss, not of Adam.
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import init_conv_eae_params
from autoencoder_based_image_compression_tpu_torch.ops.density import (
    DensityTable,
    init_density_table,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1.0e-8
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
    ...)``."""
    def leaf(get):
        return fn(*[get(state) for state in states])

    def group(get):
        return {name: fn(*[get(state)[name] for state in states])
                for name in get(states[0])}

    return TrainState(
        params=group(lambda s: s.params),
        density=DensityTable(leaf(lambda s: s.density.parameters),
                             leaf(lambda s: s.density.nb_itvs_per_side)),
        bin_widths=leaf(lambda s: s.bin_widths),
        opt_eae=AdamState(leaf(lambda s: s.opt_eae.count), group(lambda s: s.opt_eae.mu),
                          group(lambda s: s.opt_eae.nu)),
        step=leaf(lambda s: s.step))


def state_leaves(state):
    """The state's tensors as one flat list, in the fixed order in which
    :func:`map_state` visits them (the flat view of a state)."""
    leaves = []
    map_state(lambda leaf: leaves.append(leaf) or leaf, state)
    return leaves


def copy_state_into(buffers, state):
    """Copies every leaf of ``state`` into the same leaf of ``buffers``, a
    state of the same shapes and dtypes, in place (one multi-tensor copy
    on the device). Returns ``buffers``."""
    torch._foreach_copy_(state_leaves(buffers), state_leaves(state))
    return buffers


def clone_state(state):
    """A copy of the state that shares no storage with it."""
    return map_state(torch.clone, state)


def state_to(state, device):
    """The state (a :class:`TrainState`, or an SVHN state: named tuples
    and dicts of tensors) with every leaf moved to ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {name: state_to(leaf, device) for (name, leaf) in state.items()}
    return type(state)(*(state_to(leaf, device) for leaf in state))


def init_adam(params):
    """Zero moments and a zero count, on the params' device."""
    device = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu={name: torch.zeros_like(value) for (name, value) in params.items()},
                     nu={name: torch.zeros_like(value) for (name, value) in params.items()})


def learning_rate(gamma_scaling, count):
    """Adam's learning rate at ``count`` updates, as a float32 scalar
    tensor on ``count``'s device: ``LR_EAE``, times 0.1 from each of the
    two gamma-keyed boundaries on (``count >= boundary``; reference
    ``EntropyAutoencoder.py:235-243``)."""
    lr = torch.full((), csts.LR_EAE, dtype=torch.float32, device=count.device)
    for boundary in csts.lr_boundaries(gamma_scaling):
        lr = torch.where(count >= boundary, LR_DECAY * lr, lr)
    return lr


def current_lr(gamma_scaling, step):
    """Adam's learning rate at a global step, as a Python float (for the
    epoch printout; reference ``training_eae_imagenet.py:199-200``)."""
    lr = csts.LR_EAE
    for boundary in csts.lr_boundaries(gamma_scaling):
        if step >= boundary:
            lr *= LR_DECAY
    return lr


def adam_update(grads, opt_state, params, gamma_scaling):
    """One Adam step. Returns ``(new_params, new_opt_state)``.

    ``mu = 0.9 mu + 0.1 g``; ``nu = 0.999 nu + 0.001 g^2``; both divided
    by ``1 - decay^(count + 1)``; the parameters move by
    ``-lr(count) * mu_hat / (sqrt(nu_hat) + 1e-8)``.
    """
    count_inc = opt_state.count + 1
    lr = learning_rate(gamma_scaling, opt_state.count)
    correction_1 = 1.0 - ADAM_B1 ** count_inc.to(torch.float32)
    correction_2 = 1.0 - ADAM_B2 ** count_inc.to(torch.float32)
    (new_params, new_mu, new_nu) = ({}, {}, {})
    for (name, grad) in grads.items():
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * opt_state.mu[name]
        nu = (1 - ADAM_B2) * torch.square(grad) + ADAM_B2 * opt_state.nu[name]
        update = (mu / correction_1) / (torch.sqrt(nu / correction_2) + ADAM_EPS)
        new_params[name] = params[name] - lr * update
        (new_mu[name], new_nu[name]) = (mu, nu)
    return (new_params, AdamState(count=count_inc, mu=new_mu, nu=new_nu))


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
