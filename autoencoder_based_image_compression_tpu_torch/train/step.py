"""The alternating training updates, as plain functions on a state.

One ``train_step`` keeps the reference's ordering
(``eae/batching.py:129-165``, ``EntropyAutoencoder.py:484-540``):

    1. expand the density grid if the latents overflow it
    2. one SGD step on the density parameters, then their projection
    3. one Adam step on the autoencoder parameters and (optionally) one
       SGD step on the bin widths, against the *updated* density
    4. bin-width clip, GDN beta/gamma floors, gamma symmetrisation

``training_fct`` and ``training_eae_bw`` expose the two phases for the
density pre-fitting epochs (``eae/batching.py:102-127``).

**A model axis.** The step is written once, for M models at once
(:class:`ModelAxisStep`), the counterpart of the JAX package's ``vmap``
of its single-model step: every leaf of the state has a leading model
axis. The models' maps sit side by side in the channels
(``models/conv_eae.py::encode_stacked``, ``decode_stacked``): every
convolution is grouped over the models (the first one is one conv with
M * 128 outputs of the shared batch), every GDN site is one launch of
the stacked fp32 kernel, and the density model, the projections, Adam
and the bin widths' SGD run once over the stacked leaves. The loss is
the sum over the models of each model's ``rec_error + gamma_k *
approx_entropy + weight_decay`` (``EntropyAutoencoder.py:308-313``): the
models share no parameter, so one backward pass gives each its own
gradient. The learning rate is ``LR_EAE`` times 0.1 from each of the
model's gamma-keyed boundaries on (``train.state.learning_rate``, the
JAX ladder's ``_lr``). One model is a stack of one
(:func:`make_step_fns`: its state goes in with a leading axis of 1 and
comes out without it); the gamma ladder is a stack of its models
(``train/ladder.py``).

A ``train_step`` encodes its batch once. The density phase changes only
the density table, which the encoder never reads, so the latents of the
step's parameters serve both phases: the density phase takes them
detached and the RD loss with their autograd graph. The step equals
``training_eae_bw(training_fct(state, batch, noise_fct), batch,
noise_eae)`` bit for bit, each of which encodes for itself.

Nothing in a step reads a value back to the host: the grid's extent, the
warm-up switch and the step count are device tensors. The pre-fit's
density phase and ``evaluation`` run the encoder without autograd;
the RD loss is differentiated through the GDN kernel's
``GdnStackedFunction``.

**Phases** (``utils/tracing.py``): the density phase runs under
``density`` (in a ``train_step``, the step's one encode with it), the RD
loss from the latents under ``forward``, its gradient under ``backward``
and Adam, the bin widths and the projections under ``optimizer``:
profiler ranges everywhere, and mark kernels in a graphed epoch's
capture.

**Noise.** Where the reference takes a random key, these functions take
``noise``: a ``torch.Generator`` on the state's device, or the uniform
noise in [-0.5, 0.5) itself, so that two implementations can be fed the
same numbers. Given, it is one entry per model (a tensor of one model's
latents' shape for ``training_fct`` and ``evaluation``, a pair
``(noise_fct, noise_eae)`` for ``train_step``), which the step stacks so
that each model gets its own entry; :func:`make_step_fns`'s functions
take the one model's entry itself. From a generator, each phase draws
``(M, *latent)`` at once, model ``m``'s noise being entry ``m``, the
density phase first: for one model, what the model's own draw of its
latents' shape gives.
"""

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.quantization import add_uniform_noise
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.train.state import (
    adam_update,
    ladder_boundaries,
    map_state,
)
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase


def _flatten_maps(y_tilde):
    """(B, H, W, C) -> (C, B*H*W): row i gathers all samples of map i
    (reference ``tfutils.py:581-605``). Relies on the NHWC layout."""
    return y_tilde.reshape(-1, y_tilde.shape[-1]).t()


def _per_model(noise, nb_models):
    """``noise`` checked to be a generator or one entry per model."""
    if not isinstance(noise, torch.Generator) and len(noise) != nb_models:
        raise ValueError(f"{len(noise)} noises for {nb_models} models.")
    return noise


def _noisy_latents(noise, y, bin_widths):
    """``(y_tilde, samples)``: the stacked latents ``y`` (``(B, h, w, M *
    128)``) plus each model's bin widths times uniform noise in [-0.5,
    0.5), and their samples ``(M, 128, B*h*w)``, row ``(m, i)`` every
    sample of model ``m``'s map ``i`` (:func:`_flatten_maps` per model).
    The noise is drawn as ``(M, B, h, w, 128)`` from a generator, or the
    M given tensors stacked (:func:`_per_model`)."""
    (batch, height, width, channels) = y.shape
    nb_models = channels // csts.NB_MAPS_3
    if isinstance(noise, torch.Generator):
        drawn = torch.rand((nb_models, batch, height, width, csts.NB_MAPS_3), generator=noise,
                           device=y.device, dtype=y.dtype) - 0.5
    else:
        drawn = torch.stack([n.to(device=y.device) for n in _per_model(noise, nb_models)])
        if drawn.shape[1:] != (batch, height, width, csts.NB_MAPS_3):
            raise ValueError(f"noise of shape {tuple(drawn.shape[1:])} for latents of shape "
                             f"{(batch, height, width, csts.NB_MAPS_3)}.")
    y_tilde = y + bin_widths.reshape(-1) * drawn.permute(1, 2, 3, 0, 4).reshape(y.shape)
    return (y_tilde, y_tilde.reshape(-1, nb_models, csts.NB_MAPS_3).permute(1, 2, 0))


def _density_update(states, y, noise, ppi, max_itvs):
    """Expansion + one density SGD step + projection of every model at
    once on the stacked latents ``y`` (reference
    ``EntropyAutoencoder.py:484-506``, ``training_fct``): the tables grown
    to hold each model's latents (each model's largest latent stays on
    the device), one SGD step on the sum of the models' density losses,
    each model's table getting its own gradient, and the projection; the
    noise is drawn here."""
    nb_models = states.step.shape[0]
    with torch.no_grad():
        (_, samples) = _noisy_latents(noise, y, states.bin_widths)
        max_abs = (y.reshape(-1, nb_models, y.shape[-1] // nb_models).abs().amax(dim=(0, 2))
                   + 0.5 * states.bin_widths.amax(dim=-1))
        table = dens.expand_table(states.density, max_abs, ppi, max_itvs)
        mask = dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs)
    parameters = table.parameters.detach().requires_grad_(True)
    with torch.enable_grad():
        prob = dens.approximate_probability(samples, parameters, ppi, max_itvs)
        loss = torch.sum(dens.loss_density_approximation(prob, parameters, mask, ppi))
    (grads,) = torch.autograd.grad(loss, parameters)
    with torch.no_grad():
        new_parameters = dens.project_density_parameters(
            table.parameters - csts.LR_FCT * grads, mask)
    return states._replace(density=table._replace(parameters=new_parameters))


def _rd_loss(params, bin_widths, density_table, visible_units, y, noise, gammas,
             learn_bin_widths, ppi, max_itvs):
    """Rate-distortion objective of the autoencoders and the bin widths,
    from the float32 batch's stacked latents ``y`` (``None``: the batch is
    encoded here): the sum over the models of ``rec_error + gamma *
    approx_entropy + WEIGHT_DECAY_P * l2`` (reference
    ``EntropyAutoencoder.py:308-313``). The density parameters are inputs,
    not optimisation variables. Returns ``(loss, (rec_errors,
    approx_entropies))``, the last two ``(M,)``; the noise is drawn here."""
    if y is None:
        y = conv_eae.encode_stacked(params, visible_units, learn_bin_widths)
    (y_tilde, samples) = _noisy_latents(noise, y, bin_widths)
    prob = dens.approximate_probability(samples, density_table.parameters, ppi, max_itvs)
    approx_entropy = dens.approximate_entropy(prob, bin_widths)
    reconstruction = conv_eae.decode_stacked(params, y_tilde, learn_bin_widths)
    rec_error = torch.mean(torch.sum(torch.square(visible_units - reconstruction), dim=(1, 2)),
                           dim=0)
    weight_decay = csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norms(params)
    loss = rec_error + gammas * approx_entropy + weight_decay
    return (torch.sum(loss), (rec_error, approx_entropy))


def _leaves(state, learn_bin_widths):
    """The autograd leaves of the parameters and the bin widths (these
    require grad only when they are learned)."""
    params = {name: value.detach().requires_grad_(True)
              for (name, value) in state.params.items()}
    return (params, state.bin_widths.detach().requires_grad_(learn_bin_widths))


def _project_gdn(params, learn_bin_widths):
    """Beta/gamma floors, then gamma symmetrisation, in the reference's
    order (``EntropyAutoencoder.py:352-382``)."""
    indices = [1, 2, 5, 6] if learn_bin_widths else [1, 2, 3, 4, 5, 6]
    new = dict(params)
    for i in indices:
        new[f"beta_{i}"] = torch.clamp_min(new[f"beta_{i}"], csts.MIN_GAMMA_BETA)
        gamma = torch.clamp_min(new[f"gamma_{i}"], csts.MIN_GAMMA_BETA)
        new[f"gamma_{i}"] = 0.5 * (gamma + gamma.transpose(-1, -2))
    return new


class ModelAxisStep:
    """The step functions of the models ``gammas``, over states with a
    leading model axis: one model (a stack of one), a whole ladder, or
    one block of a sharded one. Each takes and returns such a state.

    ``bw_warmup_steps``: cold-start mitigation for joint bin-width
    learning. Early in training the latents are small against the clip
    floor of 0.8, so the entropy term inflates the bin widths instead of
    the transform scaling its latents up. While a model's ``step <
    bw_warmup_steps`` its upper clip is ``bw_warmup_max`` instead of
    ``MAX_BW``; 0 disables it (the reference's [0.8, 4.0] at every step).
    """

    def __init__(self, gammas, learn_bin_widths=False, ppi=csts.NB_POINTS_PER_INTERVAL,
                 max_itvs=csts.MAX_ITVS_PER_SIDE, bw_warmup_steps=0, bw_warmup_max=1.0):
        (self.gammas, self.learn_bin_widths) = (list(gammas), learn_bin_widths)
        (self.ppi, self.max_itvs) = (ppi, max_itvs)
        (self.bw_warmup_steps, self.bw_warmup_max) = (bw_warmup_steps, bw_warmup_max)
        self._constants = {}
        self.fit_epoch = epoch_fn(self.training_fct)
        self.train_epoch = epoch_fn(self.train_step)

    def constants(self, device):
        """``(gammas, learning-rate boundaries)`` as tensors on ``device``,
        made once per device (a capture refuses a host-to-device copy,
        and the warm-up step before it makes them)."""
        if device not in self._constants:
            self._constants[device] = (
                torch.tensor(self.gammas, dtype=torch.float32, device=device),
                ladder_boundaries(self.gammas, device))
        return self._constants[device]

    def training_fct(self, states, batch, noise):
        """The density phase alone, which encodes the batch itself."""
        with phase("density"):
            with torch.no_grad():
                y = conv_eae.encode_stacked(states.params, batch.to(torch.float32),
                                            self.learn_bin_widths)
            return _density_update(states, y, noise, self.ppi, self.max_itvs)

    def rd_gradients(self, states, batch, noise, leaves=None, y=None):
        """Gradients of the summed RD loss at ``states``: ``(grads_params,
        grads_bin_widths, loss)``, detached, in the phases ``forward`` and
        ``backward``. The bin widths' gradient is ``None`` unless they are
        learned. ``leaves`` are the autograd leaves of :func:`_leaves` and
        ``y`` the batch's latents under them; by default both are made here."""
        (params, bin_widths) = leaves or _leaves(states, self.learn_bin_widths)
        (gammas, _) = self.constants(states.step.device)
        with phase("forward"), torch.enable_grad():
            (loss, _) = _rd_loss(params, bin_widths, states.density, batch.to(torch.float32), y,
                                 noise, gammas, self.learn_bin_widths, self.ppi, self.max_itvs)
        names = list(params)
        inputs = [params[name] for name in names] + (
            [bin_widths] if self.learn_bin_widths else [])
        with phase("backward"):
            grads = torch.autograd.grad(loss, inputs)
        grads_bw = grads[len(names)] if self.learn_bin_widths else None
        return (dict(zip(names, grads)), grads_bw, loss.detach())

    def _update(self, states, grads_params, grads_bw):
        """Joint Adam + bin-width SGD update of every model from the RD
        gradients, then the projections (reference
        ``EntropyAutoencoder.py:508-540``, ``training_eae_bw``), under the
        ``optimizer`` phase."""
        (_, boundaries) = self.constants(states.step.device)
        with phase("optimizer"), torch.no_grad():
            (params, opt_eae) = adam_update(grads_params, states.opt_eae, states.params, boundaries)
            bin_widths = states.bin_widths
            if self.learn_bin_widths:
                # Each model's upper clip: MAX_BW, or bw_warmup_max during its warm-up.
                max_bw = torch.where(states.step[:, None] < self.bw_warmup_steps,
                                     self.bw_warmup_max, csts.MAX_BW)
                bin_widths = torch.minimum(
                    torch.clamp_min(bin_widths - csts.LR_BW * grads_bw, csts.MIN_BW), max_bw)
            params = _project_gdn(params, self.learn_bin_widths)
        return states._replace(params=params, bin_widths=bin_widths, opt_eae=opt_eae,
                               step=states.step + 1)

    def training_eae_bw(self, states, batch, noise):
        """The autoencoder and bin-width phase alone, which encodes the
        batch itself."""
        return self._update(states, *self.rd_gradients(states, batch, noise)[:2])

    def train_step(self, states, batch, noise):
        # One generator serves both phases in turn, the density phase first.
        (noise_fct, noise_eae) = ((noise, noise) if isinstance(noise, torch.Generator)
                                  else zip(*_per_model(noise, len(self.gammas))))
        # One encode serves both phases: the density phase changes only the
        # tables, which the encoder never reads.
        leaves = _leaves(states, self.learn_bin_widths)
        with phase("density"):
            # Batches may arrive as uint8 rows of a device-resident dataset;
            # the cast to float32 happens here, on the device.
            batch = batch.to(torch.float32)
            with torch.enable_grad():
                y = conv_eae.encode_stacked(leaves[0], batch, self.learn_bin_widths)
            states = _density_update(states, y.detach(), noise_fct, self.ppi, self.max_itvs)
        return self._update(states, *self.rd_gradients(states, batch, noise_eae, leaves, y)[:2])

    @torch.no_grad()
    def evaluation(self, states, batch, noise):
        """Each model's ``(rec_errors, approx_entropies)``, ``(M,)`` each:
        the noise-perturbed RD-loss components against the current tables."""
        (gammas, _) = self.constants(states.step.device)
        (_, indicators) = _rd_loss(states.params, states.bin_widths, states.density,
                                   batch.to(torch.float32), None, noise, gammas,
                                   self.learn_bin_widths, self.ppi, self.max_itvs)
        return indicators


def _stack_of_one(state, noise):
    """One model's state as a stack of one (every leaf a view with a
    leading axis of 1), and its noise as the one model's entry."""
    return (map_state(lambda leaf: leaf.unsqueeze(0), state),
            noise if isinstance(noise, torch.Generator) else [noise])


def _one_model(fn):
    """``fn``, a :class:`ModelAxisStep` function, on one model's state as
    a stack of one (:func:`_stack_of_one`): a leaf comes out as a view
    without the model axis, or as the given tensor where the step left it."""
    def step(state, batch, noise):
        (stacked, noise) = _stack_of_one(state, noise)
        return map_state(lambda leaf, before, given: given if leaf is before else leaf[0],
                         fn(stacked, batch, noise), stacked, state)
    return step


def rd_gradients(state, visible_units, noise, gamma_scaling, learn_bin_widths, ppi, max_itvs):
    """Gradients of one model's RD loss at ``state``: ``(grads_params,
    grads_bin_widths, loss)``, detached, the one-model view of
    :meth:`ModelAxisStep.rd_gradients`. The bin widths' gradient is
    ``None`` unless they are learned."""
    (stacked, noise) = _stack_of_one(state, noise)
    (grads, grads_bw, loss) = ModelAxisStep([gamma_scaling], learn_bin_widths, ppi,
                                            max_itvs).rd_gradients(stacked, visible_units, noise)
    return ({name: grad[0] for (name, grad) in grads.items()},
            None if grads_bw is None else grads_bw[0], loss)


def make_step_fns(gamma_scaling, learn_bin_widths, ppi=csts.NB_POINTS_PER_INTERVAL,
                  max_itvs=csts.MAX_ITVS_PER_SIDE, bw_warmup_steps=0, bw_warmup_max=1.0):
    """Builds the training and evaluation functions of one experiment;
    the training functions are :class:`ModelAxisStep`'s on a stack of one,
    each taking and returning a :class:`TrainState` of one model.

    Returns a dict with:

    - ``training_fct(state, batch, noise)``: density-only update (the
      pre-fitting epochs)
    - ``fit_epoch(state, dataset, rows, noise)``: ``training_fct`` over
      the rows (the pre-fit epoch's batches in order,
      ``epoch_graph.rows_in_order``), graphed on the card and the eager
      loop on the CPU as ``train_epoch`` is; the counterpart of the JAX
      package's jitted ``training_fct``, one program a batch
    - ``training_eae_bw(state, batch, noise)``: autoencoder + bin-width
      update
    - ``train_step(state, batch, noise)``: the per-batch alternation,
      density phase THEN autoencoder phase, over one encode of the batch
    - ``train_epoch(state, dataset, rows, noise)``: the alternation over
      the ``(nb_batches, batch_size)`` row indices of a device-resident
      uint8 dataset, each batch gathered on the device; ``noise`` is a
      generator or one ``train_step`` noise per batch. On the card, the
      replays of one captured ``train_step`` (``train/epoch_graph.py``,
      the counterpart of the JAX package's scanned epoch); on the CPU,
      the eager loop. The returned state shares no storage with the
      given one or with the graph
    - ``evaluation(state, batch, noise)``: the training indicators
      (reference ``EntropyAutoencoder.py:542-589``): ``(scaled_approx_entropy,
      rec_error, loss_density_approx, y, approx_entropy_per_map
      [UNCLAMPED], areas_under_pdfs, weight_decay)``
    """
    stack = ModelAxisStep([gamma_scaling], learn_bin_widths, ppi, max_itvs, bw_warmup_steps,
                          bw_warmup_max)
    training_fct = _one_model(stack.training_fct)
    train_step = _one_model(stack.train_step)

    @torch.no_grad()
    def evaluation(state, batch, noise):
        batch = batch.to(torch.float32)
        y = conv_eae.encode(state.params, batch, learn_bin_widths)
        y_tilde = add_uniform_noise(noise, y, state.bin_widths)
        table = dens.expand_table(state.density, y.abs().max() + 0.5 * state.bin_widths.max(),
                                  ppi, max_itvs)
        mask = dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs)
        prob = dens.approximate_probability(_flatten_maps(y_tilde), table.parameters, ppi,
                                            max_itvs)
        # Per-map approximate entropies stay UNCLAMPED so that the host
        # monitor can flag negative values (the reference asserts).
        approx_per_map = dens.approximate_entropy_per_map(prob, state.bin_widths)
        scaled_approx_entropy = gamma_scaling * torch.sum(torch.clamp_min(approx_per_map, 0.0))
        loss_density = dens.loss_density_approximation(prob, table.parameters, mask, ppi)
        reconstruction = conv_eae.decode(state.params, y_tilde, learn_bin_widths)
        rec_error = torch.mean(torch.sum(torch.square(batch - reconstruction), dim=(1, 2, 3)))
        areas = dens.area_under_piecewise_linear_functions(
            table.parameters, table.nb_itvs_per_side, ppi, max_itvs)
        weight_decay = csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norm(state.params)
        return (scaled_approx_entropy, rec_error, loss_density, y, approx_per_map, areas,
                weight_decay)

    return {
        "training_fct": training_fct,
        "training_eae_bw": _one_model(stack.training_eae_bw),
        "train_step": train_step,
        "fit_epoch": epoch_fn(training_fct),
        "train_epoch": epoch_fn(train_step),
        "evaluation": evaluation,
    }
