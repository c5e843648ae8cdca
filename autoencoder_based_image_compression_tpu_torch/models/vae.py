"""Variational autoencoder (the SVHN conceptual ancestor of the EAE).

Counterpart of the reference package's ``models/vae.py``, a functional
redesign of ``svhn/vae/VariationalAutoencoder.py``: a Gaussian-posterior
VAE (ReLU recognition and generation hiddens, reparametrisation trick)
trained by minimising the opposite of Kingma's VLB approximation
``alpha*KL + rec_error`` (``svhn/tools/tools.py:945-982``, KL at
``:653-674``). Defaults from ``training_vae_svhn.py:29-34``: 300 hidden,
25 latents. Weights keep the reference's ``(in, out)`` layout.

Where the reference takes a random key, these functions take ``noise``:
a ``torch.Generator`` on the parameters' device, from which the standard
normal draw is made, or that draw itself.

An epoch of steps (:func:`make_vae_epoch_fn`) is, on the card, the
replays of one captured step (``train/epoch_graph.py``), the counterpart
of the JAX package's jitted ``train_step``; on the CPU, the eager loop.
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

LR_VAE = 2.0e-5
MOMENTUM_VAE = 0.9


def init_vae_params(generator, nb_visible=3072, nb_hidden=300, nb_z=25):
    """N(0, 0.01 / 0.05) weights and zero biases, drawn from
    ``generator`` on its device."""
    device = generator.device

    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)

    def zeros(size):
        return torch.zeros(size, device=device, dtype=torch.float32)

    return {
        "wr_l1": normal((nb_visible, nb_hidden), 0.01), "br_l1": zeros(nb_hidden),
        "wr_mean": normal((nb_hidden, nb_z), 0.05), "br_mean": zeros(nb_z),
        "wr_log_std_squared": normal((nb_hidden, nb_z), 0.05),
        "br_log_std_squared": zeros(nb_z),
        "wg_l1": normal((nb_z, nb_hidden), 0.05), "bg_l1": zeros(nb_hidden),
        "wg_mean": normal((nb_hidden, nb_visible), 0.01), "bg_mean": zeros(nb_visible),
    }


def _normal(noise, shape, device):
    """``noise`` as a standard normal draw of ``shape`` on ``device``."""
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, device=device, dtype=torch.float32)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, expected {tuple(shape)}.")
    return noise.to(device)


def recognition(params, visible_units):
    """Posterior parameters ``(z_mean, z_log_std_squared)``."""
    hidden = torch.relu(visible_units @ params["wr_l1"] + params["br_l1"])
    z_mean = hidden @ params["wr_mean"] + params["br_mean"]
    z_log_std_squared = hidden @ params["wr_log_std_squared"] + params["br_log_std_squared"]
    return (z_mean, z_log_std_squared)


def generation(params, z, is_continuous=True):
    """Reconstruction mean; sigmoid output for binary visibles."""
    hidden = torch.relu(z @ params["wg_l1"] + params["bg_l1"])
    reconstruction = hidden @ params["wg_mean"] + params["bg_mean"]
    if not is_continuous:
        reconstruction = torch.sigmoid(reconstruction)
    return reconstruction


def forward_pass(params, visible_units, noise, is_continuous=True):
    """Reparametrised sample and reconstruction: ``(z_mean,
    z_log_std_squared, z, reconstruction)``."""
    visible_units = torch.as_tensor(visible_units).to(params["wr_l1"].device, torch.float32)
    (z_mean, z_log_std_squared) = recognition(params, visible_units)
    epsilon = _normal(noise, z_mean.shape, z_mean.device)
    z = z_mean + torch.exp(0.5 * z_log_std_squared) * epsilon
    reconstruction = generation(params, z, is_continuous)
    return (z_mean, z_log_std_squared, z, reconstruction)


def kl_divergence(z_mean, z_log_std_squared):
    """KL(q(z|x) || N(0, I)) (reference ``svhn/tools/tools.py:653-674``)."""
    return 0.5 * torch.mean(torch.sum(
        -1.0 - z_log_std_squared + torch.square(z_mean) + torch.exp(z_log_std_squared), dim=1))


def opposite_vlb(params, visible_units, noise, alpha, is_continuous=True):
    """alpha*KL + reconstruction error (Gaussian visible model, or the
    Bernoulli cross-entropy for binary visibles)."""
    visible_units = torch.as_tensor(visible_units).to(params["wr_l1"].device, torch.float32)
    (z_mean, z_log_std_squared, _, reconstruction) = forward_pass(
        params, visible_units, noise, is_continuous)
    if is_continuous:
        rec_error = 0.5 * torch.mean(
            torch.sum(torch.square(visible_units - reconstruction), dim=1))
    else:
        rec_error = -torch.mean(torch.sum(
            visible_units * torch.log(reconstruction)
            + (1.0 - visible_units) * torch.log(1.0 - reconstruction), dim=1))
    return alpha * kl_divergence(z_mean, z_log_std_squared) + rec_error


class VaeState(NamedTuple):
    params: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]
    step: torch.Tensor


def init_vae_state(generator, nb_visible=3072, nb_hidden=300, nb_z=25, device="cuda"):
    """Fresh state on ``device``, drawn from ``generator`` on its own
    device (a CPU generator gives the same start on any device)."""
    device = resolve_device(device)
    params = {name: value.to(device) for (name, value) in
              init_vae_params(generator, nb_visible, nb_hidden, nb_z).items()}
    return VaeState(params=params,
                    momentum={name: torch.zeros_like(value) for (name, value) in params.items()},
                    step=torch.zeros((), dtype=torch.int32, device=device))


def make_vae_step_fn(alpha, is_continuous=True):
    """SGD + momentum training step on the negative VLB,
    ``train_step(state, visible_units, noise)``."""

    def train_step(state, visible_units, noise):
        params = {name: value.detach().requires_grad_(True)
                  for (name, value) in state.params.items()}
        with torch.enable_grad():
            loss = opposite_vlb(params, visible_units, noise, alpha, is_continuous)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[name] for name in names])
        with torch.no_grad():
            momentum = {name: MOMENTUM_VAE * state.momentum[name] - LR_VAE * grad
                        for (name, grad) in zip(names, grads)}
            new_params = {name: state.params[name] + momentum[name] for name in names}
        return state._replace(params=new_params, momentum=momentum, step=state.step + 1)

    return train_step


def make_vae_epoch_fn(alpha, is_continuous=True):
    """``train_epoch(state, dataset, rows, noise)``: the training step of
    :func:`make_vae_step_fn` over the ``(nb_batches, batch_size)`` rows of
    a device-resident set; ``noise`` is a generator (registered with the
    graph on the card, so each replay draws on from it) or one draw per
    batch."""
    return epoch_fn(make_vae_step_fn(alpha, is_continuous))


@torch.no_grad()
def generate(params, noise, nb_samples, nb_z=25, is_continuous=True):
    """Samples digits from the prior (reference ``generating_vae_svhn.py``);
    ``noise`` is a generator or the ``(nb_samples, nb_z)`` prior draw."""
    z = _normal(noise, (nb_samples, nb_z), params["wg_l1"].device)
    return generation(params, z, is_continuous)
