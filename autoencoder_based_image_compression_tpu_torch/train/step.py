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

A ``train_step`` encodes its batch once. The density phase changes only
the density table, which the encoder never reads, so the latents of the
step's parameters serve both phases: the density phase takes them
detached and the RD loss with their autograd graph. The step equals
``training_eae_bw(training_fct(state, batch, noise_fct), batch,
noise_eae)`` bit for bit, each of which encodes for itself.

Nothing in a step reads a value back to the host: the grid's extent, the
warm-up switch and the step count are device tensors. The pre-fit's
density phase and ``evaluation`` run the encoder without autograd;
``_rd_loss`` is differentiated through the GDN kernel's ``GdnFunction``.

**Phases** (``utils/tracing.py``): the density phase runs under
``density`` (in a ``train_step``, the step's one encode with it), the RD
loss from the latents under ``forward``, its gradient under ``backward``
and Adam, the bin widths and the projections under ``optimizer``:
profiler ranges everywhere, and mark kernels in a graphed epoch's
capture.

**Noise.** Where the reference takes a random key, these functions take
``noise``: a ``torch.Generator`` on the state's device, or the uniform
noise in [-0.5, 0.5) itself, of the latents' shape (for ``train_step`` a
pair, density phase first), so that two implementations can be fed the
same numbers.
"""

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.quantization import add_uniform_noise
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import (  # noqa: F401
    epoch_fn,
    epoch_over_rows,
)
from autoencoder_based_image_compression_tpu_torch.train.state import adam_update
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase


def _flatten_maps(y_tilde):
    """(B, H, W, C) -> (C, B*H*W): row i gathers all samples of map i
    (reference ``tfutils.py:581-605``). Relies on the NHWC layout."""
    return y_tilde.reshape(-1, y_tilde.shape[-1]).t()


def _expanded_table(state, y, ppi, max_itvs):
    """The density table grown to hold the latents ``y``, and its mask."""
    max_abs = torch.max(torch.abs(y)) + 0.5 * torch.max(state.bin_widths)
    table = dens.expand_table(state.density, max_abs, ppi, max_itvs)
    return (table, dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs))


def _density_update(state, y, noise, ppi, max_itvs):
    """Expansion + one density SGD step + projection on the batch's
    latents ``y`` (reference ``EntropyAutoencoder.py:484-506``,
    ``training_fct``); the noise is drawn here."""
    with torch.no_grad():
        y_tilde = add_uniform_noise(noise, y, state.bin_widths)
        (table, mask) = _expanded_table(state, y, ppi, max_itvs)
        samples = _flatten_maps(y_tilde)
    parameters = table.parameters.detach().requires_grad_(True)
    with torch.enable_grad():
        prob = dens.approximate_probability(samples, parameters, ppi, max_itvs)
        loss = dens.loss_density_approximation(prob, parameters, mask, ppi)
    (grads,) = torch.autograd.grad(loss, parameters)
    with torch.no_grad():
        new_parameters = dens.project_density_parameters(
            table.parameters - csts.LR_FCT * grads, mask)
    return state._replace(density=table._replace(parameters=new_parameters))


def _density_phase(state, visible_units, noise, learn_bin_widths, ppi, max_itvs):
    """:func:`_density_update` on the batch's latents, encoded here."""
    with torch.no_grad():
        y = conv_eae.encode(state.params, visible_units.to(torch.float32), learn_bin_widths)
    return _density_update(state, y, noise, ppi, max_itvs)


def _rd_loss_of_latents(params, bin_widths, visible_units, y, noise, density_table,
                        gamma_scaling, learn_bin_widths, ppi, max_itvs):
    """:func:`_rd_loss` from the float32 batch's latents ``y``; the noise
    is drawn here."""
    y_tilde = add_uniform_noise(noise, y, bin_widths)
    prob = dens.approximate_probability(_flatten_maps(y_tilde), density_table.parameters,
                                        ppi, max_itvs)
    approx_entropy = dens.approximate_entropy(prob, bin_widths)
    reconstruction = conv_eae.decode(params, y_tilde, learn_bin_widths)
    diff_sq = torch.square(visible_units - reconstruction)
    rec_error = torch.mean(torch.sum(diff_sq, dim=(1, 2, 3)))
    weight_decay = csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norm(params)
    loss = rec_error + gamma_scaling * approx_entropy + weight_decay
    return (loss, (rec_error, approx_entropy))


def _rd_loss(params, bin_widths, visible_units, noise, density_table, gamma_scaling,
             learn_bin_widths, ppi, max_itvs):
    """Rate-distortion objective of the autoencoder and the bin widths:
    ``rec_error + gamma * approx_entropy + WEIGHT_DECAY_P * l2``
    (reference ``EntropyAutoencoder.py:308-313``). The density
    parameters are inputs, not optimisation variables. Returns
    ``(loss, (rec_error, approx_entropy))``."""
    visible_units = visible_units.to(torch.float32)
    y = conv_eae.encode(params, visible_units, learn_bin_widths)
    return _rd_loss_of_latents(params, bin_widths, visible_units, y, noise, density_table,
                               gamma_scaling, learn_bin_widths, ppi, max_itvs)


def _leaves(state, learn_bin_widths):
    """The autograd leaves of the parameters and the bin widths (these
    require grad only when they are learned)."""
    params = {name: value.detach().requires_grad_(True)
              for (name, value) in state.params.items()}
    return (params, state.bin_widths.detach().requires_grad_(learn_bin_widths))


def _gradients(loss, params, bin_widths, learn_bin_widths):
    """``(grads_params, grads_bin_widths, loss)`` of ``loss`` at the
    leaves of :func:`_leaves`, detached, under the ``backward`` phase."""
    names = list(params)
    inputs = [params[name] for name in names] + ([bin_widths] if learn_bin_widths else [])
    with phase("backward"):
        grads = torch.autograd.grad(loss, inputs)
    grads_bw = grads[len(names)] if learn_bin_widths else None
    return (dict(zip(names, grads)), grads_bw, loss.detach())


def rd_gradients(state, visible_units, noise, gamma_scaling, learn_bin_widths, ppi, max_itvs):
    """Gradients of :func:`_rd_loss` at ``state``: ``(grads_params,
    grads_bin_widths, loss)``, detached. The bin widths' gradient is
    ``None`` unless they are learned."""
    (params, bin_widths) = _leaves(state, learn_bin_widths)
    with phase("forward"), torch.enable_grad():
        (loss, _) = _rd_loss(params, bin_widths, visible_units, noise, state.density,
                             gamma_scaling, learn_bin_widths, ppi, max_itvs)
    return _gradients(loss, params, bin_widths, learn_bin_widths)


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


def _eae_bw_update(state, grads_params, grads_bw, gamma_scaling, learn_bin_widths,
                   bw_warmup_steps=0, bw_warmup_max=1.0):
    """Joint Adam + bin-width SGD update from the RD gradients, then the
    projections (reference ``EntropyAutoencoder.py:508-540``,
    ``training_eae_bw``).

    ``bw_warmup_steps``: cold-start mitigation for joint bin-width
    learning. Early in training the latents are small against the clip
    floor of 0.8, so the entropy term inflates the bin widths instead of
    the transform scaling its latents up. While ``step <
    bw_warmup_steps`` the upper clip is ``bw_warmup_max`` instead of
    ``MAX_BW``; 0 disables it (the reference's [0.8, 4.0] at every step).
    """
    with phase("optimizer"), torch.no_grad():
        (params, opt_eae) = adam_update(grads_params, state.opt_eae, state.params,
                                        gamma_scaling)
        bin_widths = state.bin_widths
        if learn_bin_widths:
            max_bw = torch.full((), csts.MAX_BW, dtype=torch.float32,
                                device=bin_widths.device)
            if bw_warmup_steps > 0:
                max_bw = torch.where(state.step < bw_warmup_steps, bw_warmup_max, max_bw)
            bin_widths = torch.minimum(
                torch.clamp_min(bin_widths - csts.LR_BW * grads_bw, csts.MIN_BW), max_bw)
        params = _project_gdn(params, learn_bin_widths)
    return state._replace(params=params, bin_widths=bin_widths, opt_eae=opt_eae,
                          step=state.step + 1)


def make_step_fns(gamma_scaling, learn_bin_widths, ppi=csts.NB_POINTS_PER_INTERVAL,
                  max_itvs=csts.MAX_ITVS_PER_SIDE, bw_warmup_steps=0, bw_warmup_max=1.0):
    """Builds the training and evaluation functions of one experiment.

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
    static = dict(learn_bin_widths=learn_bin_widths, ppi=ppi, max_itvs=max_itvs)
    update = dict(gamma_scaling=gamma_scaling, learn_bin_widths=learn_bin_widths,
                  bw_warmup_steps=bw_warmup_steps, bw_warmup_max=bw_warmup_max)

    def training_fct(state, batch, noise):
        with phase("density"):
            return _density_phase(state, batch, noise, **static)

    def training_eae_bw(state, batch, noise):
        (grads_params, grads_bw, _) = rd_gradients(state, batch, noise, gamma_scaling,
                                                   **static)
        return _eae_bw_update(state, grads_params, grads_bw, **update)

    def train_step(state, batch, noise):
        # One generator serves both phases in turn.
        (noise_fct, noise_eae) = ((noise, noise) if isinstance(noise, torch.Generator)
                                  else noise)
        (params, bin_widths) = _leaves(state, learn_bin_widths)
        with phase("density"):
            # Batches may arrive as uint8 rows of a device-resident dataset;
            # the cast to float32 happens here, on the device.
            batch = batch.to(torch.float32)
            with torch.enable_grad():
                y = conv_eae.encode(params, batch, learn_bin_widths)
            state = _density_update(state, y.detach(), noise_fct, ppi, max_itvs)
        with phase("forward"), torch.enable_grad():
            (loss, _) = _rd_loss_of_latents(params, bin_widths, batch, y, noise_eae,
                                            state.density, gamma_scaling, **static)
        (grads_params, grads_bw, _) = _gradients(loss, params, bin_widths, learn_bin_widths)
        return _eae_bw_update(state, grads_params, grads_bw, **update)

    @torch.no_grad()
    def evaluation(state, batch, noise):
        batch = batch.to(torch.float32)
        y = conv_eae.encode(state.params, batch, learn_bin_widths)
        y_tilde = add_uniform_noise(noise, y, state.bin_widths)
        (table, mask) = _expanded_table(state, y, ppi, max_itvs)
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
        "training_eae_bw": training_eae_bw,
        "train_step": train_step,
        "fit_epoch": epoch_fn(training_fct),
        "train_epoch": epoch_fn(train_step),
        "evaluation": evaluation,
    }
