"""Dense entropy autoencoder (the SVHN pedagogical model).

Counterpart of the reference package's ``models/dense_eae.py``, itself a
functional redesign of ``svhn/eae/EntropyAutoencoder.py``: a
fully-connected EAE (3072 visible -> 300 hidden leaky-ReLU -> 200
latents; mirrored decoder) with a *single* scalar piecewise-linear
density shared by all latents and a scalar learned bin width. The
reference derives every gradient by hand; here autograd differentiates
the same objective, and the noise is ``bw * eps`` with ``eps`` fixed, so
the bin width's gradient is the reference's closed form.

Weights keep the reference's ``(in, out)`` layout with ``x @ W``, so a
checkpoint's arrays carry across unchanged. The matmuls run in true fp32
on the card (``resolve_device`` turns TF32 off).

**Noise.** Where the reference takes a random key, the step functions
take ``noise``: a ``torch.Generator`` on the state's device, from which
U[-0.5, 0.5) of the latents' shape is drawn, or that ``eps`` itself.
``train_step`` draws one ``eps`` per batch and hands the same tensor to
both phases, as the reference's command lines do with one key.

**Epochs.** ``fit_epoch`` (the density pre-fit) and ``train_epoch``
(the alternation) run a step over the ``(nb_batches, batch_size)`` rows
of a device-resident set: on the card, the replays of one captured step
(``train/epoch_graph.py``), the counterpart of the JAX package's jitted
steps, one program a call; on the CPU, the eager loop.

Defaults from ``EntropyAutoencoder.__init__``: 4 points per interval, 10
intervals per side, lr_eae 4e-5 with momentum 0.9, lr_fct 0.2, lr_bw
1e-5 with floor 0.1, weight decay 5e-4.
"""

import math
from typing import Dict, NamedTuple

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.metrics import discrete_entropy
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

# SVHN-side hyperparameter defaults.
PPI = 4
NB_ITVS_INIT = 10
MAX_ITVS = 64
LR_EAE = 4.0e-5
MOMENTUM_EAE = 0.9
LR_FCT = 0.2
LR_BW = 1.0e-5
MIN_BW = 0.1
WEIGHT_DECAY_P = 5.0e-4
WEIGHT_NAMES = ("we_l1", "we_latent", "wd_l1", "wd_mean")


def leaky_relu(x):
    """Leaky ReLU with slope 0.1 (reference ``svhn/tools/tools.py:676``)."""
    return torch.where(x < 0.0, 0.1 * x, x)


def init_dense_eae_params(generator, nb_visible=3072, nb_hidden=300, nb_y=200):
    """Gaussian inits N(0, 0.01 / 0.05) per layer and zero biases,
    drawn from ``generator`` on its device (reference
    ``svhn/eae/EntropyAutoencoder.py:146-180``)."""
    device = generator.device

    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)

    def zeros(size):
        return torch.zeros(size, device=device, dtype=torch.float32)

    return {
        "we_l1": normal((nb_visible, nb_hidden), 0.01), "be_l1": zeros(nb_hidden),
        "we_latent": normal((nb_hidden, nb_y), 0.05), "be_latent": zeros(nb_y),
        "wd_l1": normal((nb_y, nb_hidden), 0.05), "bd_l1": zeros(nb_hidden),
        "wd_mean": normal((nb_hidden, nb_visible), 0.01), "bd_mean": zeros(nb_visible),
    }


def encoder(params, visible_units):
    """Returns (hidden, latents) (reference ``:218-247``)."""
    hidden = leaky_relu(visible_units @ params["we_l1"] + params["be_l1"])
    y = hidden @ params["we_latent"] + params["be_latent"]
    return (hidden, y)


def decoder(params, y_tilde):
    """Returns (hidden, reconstruction) (reference ``:249-278``)."""
    hidden = leaky_relu(y_tilde @ params["wd_l1"] + params["bd_l1"])
    reconstruction = hidden @ params["wd_mean"] + params["bd_mean"]
    return (hidden, reconstruction)


def weights_decay(params):
    """0.5 * sum of squared weights over the 4 weight matrices."""
    return sum(0.5 * torch.sum(torch.square(params[name])) for name in WEIGHT_NAMES)


class DenseEaeState(NamedTuple):
    """Training state: parameters, momentum buffers, the shared density,
    the scalar bin width and the step, all tensors on one device."""

    params: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]
    density: dens.DensityTable
    bin_width: torch.Tensor
    step: torch.Tensor


def init_dense_eae_state(generator, bin_width_init=1.0, nb_visible=3072, nb_hidden=300,
                         nb_y=200, max_itvs=MAX_ITVS, device="cuda"):
    """Fresh state on ``device``. The parameters are drawn from
    ``generator`` on its own device, so a CPU generator gives the same
    start on any device."""
    device = resolve_device(device)
    params = {name: value.to(device) for (name, value) in
              init_dense_eae_params(generator, nb_visible, nb_hidden, nb_y).items()}
    return DenseEaeState(
        params=params,
        momentum={name: torch.zeros_like(value) for (name, value) in params.items()},
        density=dens.init_density_table(1, PPI, max_itvs, NB_ITVS_INIT, device=device),
        bin_width=torch.tensor(bin_width_init, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def uniform_eps(noise, shape, device):
    """``noise`` as float32 U[-0.5, 0.5) of ``shape`` on ``device``: drawn
    from it when it is a generator, checked and returned when it is the
    draw."""
    if isinstance(noise, torch.Generator):
        return torch.rand(shape, generator=noise, device=device, dtype=torch.float32) - 0.5
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for latents of shape "
                         f"{tuple(shape)}.")
    return noise.to(device)


def _latent_shape(state, visible_units):
    return (visible_units.shape[0], state.params["we_latent"].shape[1])


def _rows(state, visible_units):
    """A batch (numpy or tensor) as float32 rows on the state's device."""
    return torch.as_tensor(visible_units).to(state.bin_width.device, torch.float32)


def _approx_entropy_scalar(y_tilde_flat, parameters, bin_width, max_itvs):
    """Mean -log2 p over all latents minus log2(bin width): SVHN's single
    shared density (reference ``svhn/tools/tools.py:21-77``)."""
    prob = dens.approximate_probability(y_tilde_flat[None, :], parameters, PPI, max_itvs)
    diff_entropy = torch.mean(-torch.log(prob) / math.log(2.0))
    return diff_entropy - torch.log(bin_width) / math.log(2.0)


def _rec_error(visible_units, reconstruction):
    return 0.5 * torch.mean(torch.sum(torch.square(visible_units - reconstruction), dim=1))


def _loss_eae(params, bin_width, visible_units, eps, parameters, gamma, max_itvs):
    """0.5*mean(sum sq) + gamma*approx_entropy + weight decay (reference
    ``svhn/tools/tools.py:1125-1165``, ``:758``)."""
    (_, y) = encoder(params, visible_units)
    y_tilde = y + bin_width * eps
    (_, reconstruction) = decoder(params, y_tilde)
    rec_error = _rec_error(visible_units, reconstruction)
    approx_entropy = _approx_entropy_scalar(y_tilde.flatten(), parameters, bin_width, max_itvs)
    return (rec_error + gamma * approx_entropy + WEIGHT_DECAY_P * weights_decay(params),
            (rec_error, approx_entropy))


def make_dense_step_fns(gamma, is_bin_width_learned, max_itvs=MAX_ITVS):
    """The training and evaluation functions of the SVHN EAE.

    Mirrors ``svhn/eae/EntropyAutoencoder.py:1054-1117``: plain SGD on
    the density, SGD + momentum (0.9) on the autoencoder, SGD with floor
    0.1 on the bin width. Returns a dict with:

    - ``training_fct(state, visible_units, noise)``: the density step;
    - ``training_eae_bw(state, visible_units, noise)``: the autoencoder
      and bin-width step;
    - ``train_step(state, visible_units, noise)``: the alternation, one
      ``eps`` drawn from ``noise`` (or ``noise`` itself) for both phases;
    - ``fit_epoch(state, dataset, rows, noise)``: ``training_fct`` over
      the rows (the pre-fit), ``noise`` a generator or one ``eps`` a batch;
    - ``train_epoch(state, dataset, rows, noise)``: ``train_step`` over
      the rows, ``noise`` likewise;
    - ``evaluation(state, visible_units, noise)``: the indicators, eager.
    """

    def training_fct(state, visible_units, noise):
        with torch.no_grad():
            (_, y) = encoder(state.params, _rows(state, visible_units))
            y_tilde = y + state.bin_width * uniform_eps(noise, y.shape, y.device)
            max_abs = torch.max(torch.abs(y)) + 0.5 * state.bin_width
            table = dens.expand_table(state.density, max_abs, PPI, max_itvs)
            mask = dens.active_mask(table.nb_itvs_per_side, PPI, max_itvs)
            samples = y_tilde.flatten()[None, :]
        parameters = table.parameters.detach().requires_grad_(True)
        with torch.enable_grad():
            prob = dens.approximate_probability(samples, parameters, PPI, max_itvs)
            loss = dens.loss_density_approximation(prob, parameters, mask, PPI)
        (grads,) = torch.autograd.grad(loss, parameters)
        with torch.no_grad():
            new_parameters = dens.project_density_parameters(
                table.parameters - LR_FCT * grads, mask)
        return state._replace(density=table._replace(parameters=new_parameters))

    def training_eae_bw(state, visible_units, noise):
        visible_units = _rows(state, visible_units)
        params = {name: value.detach().requires_grad_(True)
                  for (name, value) in state.params.items()}
        bin_width = state.bin_width.detach().requires_grad_(True)
        eps = uniform_eps(noise, _latent_shape(state, visible_units), visible_units.device)
        with torch.enable_grad():
            (loss, _) = _loss_eae(params, bin_width, visible_units, eps,
                                  state.density.parameters, gamma, max_itvs)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[name] for name in names] + [bin_width])
        with torch.no_grad():
            momentum = {name: MOMENTUM_EAE * state.momentum[name] - LR_EAE * grad
                        for (name, grad) in zip(names, grads)}
            new_params = {name: state.params[name] + momentum[name] for name in names}
            new_bin_width = state.bin_width
            if is_bin_width_learned:
                new_bin_width = torch.clamp_min(state.bin_width - LR_BW * grads[-1], MIN_BW)
        return state._replace(params=new_params, momentum=momentum, bin_width=new_bin_width,
                              step=state.step + 1)

    def train_step(state, visible_units, noise):
        eps = uniform_eps(noise, _latent_shape(state, visible_units), state.bin_width.device)
        return training_eae_bw(training_fct(state, visible_units, eps), visible_units, eps)

    @torch.no_grad()
    def evaluation(state, visible_units, noise):
        """``(approx_entropy, scaled_approx_entropy, rec_error,
        loss_density_approx, y)`` (reference ``:1119-1186``; the discrete
        entropy and the dead counts are computed on the host)."""
        visible_units = _rows(state, visible_units)
        (_, y) = encoder(state.params, visible_units)
        y_tilde = y + state.bin_width * uniform_eps(noise, y.shape, y.device)
        (_, reconstruction) = decoder(state.params, y_tilde)
        rec_error = _rec_error(visible_units, reconstruction)
        approx_entropy = _approx_entropy_scalar(y_tilde.flatten(), state.density.parameters,
                                                state.bin_width, max_itvs)
        mask = dens.active_mask(state.density.nb_itvs_per_side, PPI, max_itvs)
        samples = y_tilde.flatten()[None, :]
        prob = dens.approximate_probability(samples, state.density.parameters, PPI, max_itvs)
        loss_density = dens.loss_density_approximation(prob, state.density.parameters, mask,
                                                       PPI)
        return (approx_entropy, gamma * approx_entropy, rec_error, loss_density, y)

    return {"training_fct": training_fct, "training_eae_bw": training_eae_bw,
            "train_step": train_step, "fit_epoch": epoch_fn(training_fct),
            "train_epoch": epoch_fn(train_step), "evaluation": evaluation}


@torch.no_grad()
def compute_rate_psnr(state, visible_units, mean_training, std_training, bin_width_test):
    """Test-time rate and reconstruction of preprocessed SVHN digits.

    Reference ``svhn/eae/utils.py:8-80``: encode WITHOUT noise, quantise
    on the host with the test bin width, rate = nb_y * discrete_entropy /
    nb_visible, decode on the device, undo the preprocessing. Returns
    ``(rate, reconstruction_uint8)``; the rounding to uint8 happens on
    the host after the clip, as in the reference.
    """
    (_, y) = encoder(state.params, _rows(state, visible_units))
    y = y.cpu().numpy()
    quantized_y = bin_width_test * numpy.round(y / bin_width_test)
    nb_y = y.shape[1]
    nb_visible = visible_units.shape[1]
    rate = nb_y * discrete_entropy(quantized_y, bin_width_test) / nb_visible
    (_, reconstruction) = decoder(state.params, _rows(state, quantized_y))
    rec = reconstruction.cpu().numpy() * std_training + mean_training
    rec_uint8 = numpy.round(rec.clip(0.0, 255.0)).astype(numpy.uint8)
    return (rate, rec_uint8)
