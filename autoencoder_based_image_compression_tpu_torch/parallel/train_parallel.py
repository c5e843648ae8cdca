"""The training step over a ``(data, model)`` mesh.

Counterpart of the reference's ``parallel/train_parallel.py``. There,
the single-chip step with sharding annotations is the whole story: XLA
inserts the reductions. Here each process runs the step on its own data
blocks and reduces explicitly, and three parts of the step are not sums
of per-example terms, so that reducing each shard's gradient would give
another step:

(a) the density grid grows from ``max|y|`` over the batch: the maximum
    is reduced (``MAX``) before the table is expanded;
(b) the approximate entropy clamps each map's *batch mean* of
    ``-log2 p`` at 0: the per-map sums are reduced before the clamp,
    through a differentiable all-reduce, so that the gradient is the
    global loss's;
(c) the reconstruction error and the density loss's mean probability
    are means over the global batch: every data block holds as many
    images (checked), and every sum is divided by the global count.

Each process's loss carries the terms it shares with the other
processes of its data line (the weight decay, the clamped entropy) at
``1 / n`` of their weight, so that the sum of the processes' gradients,
which the step all-reduces, is the gradient of the global loss.

The density parameters and the bin widths are split per map over
``model``: the step gathers them within the model line first, runs on
the whole table, and each process keeps its own maps of the result.
Weights and Adam moments are replicated.

**Noise.** As in ``train/step.py``: a ``torch.Generator``, from which
every process draws the *global* noise (density phase first) and takes
its blocks' slices, or the global noise tensors themselves. The result
does not depend on how the batch is split.
"""

import math

import torch
import torch.distributed as dist

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.parallel import sharding
from autoencoder_based_image_compression_tpu_torch.parallel.sharding import (
    ShardedBatch,
    batch_sharding,
    gather_model_rows,
    model_rows,
    split_batch,
    state_shardings,
)
from autoencoder_based_image_compression_tpu_torch.train.state import adam_update
from autoencoder_based_image_compression_tpu_torch.train.step import (
    _flatten_maps,
    _project_gdn,
)

LOG2 = math.log(2.0)


def shard_state(state, mesh):
    """Places a host-built state onto the mesh with its shardings."""
    return sharding.shard_state(state, mesh)


def _all_reduce(tensor, mesh, op=dist.ReduceOp.SUM):
    """In-place reduction over this process's data line."""
    (group, _) = mesh.group("data")
    if mesh.distributed and (group is not None):
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def _all_reduce_differentiable(tensor, mesh):
    (group, _) = mesh.group("data")
    if mesh.distributed and (group is not None):
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def _all_reduce_flat(tensors, mesh):
    """Sums each tensor over the data line, in one flat reduction."""
    (group, _) = mesh.group("data")
    if not (mesh.distributed and group is not None):
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out = []
    for t in tensors:
        out.append(flat[:t.numel()].view_as(t))
        flat = flat[t.numel():]
    return out


def _blocks(batch):
    """``[(d, images)]`` of this process's data blocks, in order."""
    return [(d, piece) for ((d, _), piece) in batch.pieces.items()]


def _noise_blocks(noise, batch, latent_tail, device, count):
    """``count`` lists of per-block noise slices, from a generator (the
    global noise drawn in turn) or from the global noise tensors."""
    per_block = next(iter(batch.pieces.values())).shape[0]
    shape = (batch.global_shape[0],) + latent_tail
    if isinstance(noise, torch.Generator):
        noise = [torch.rand(shape, generator=noise, device=device) - 0.5 for _ in range(count)]
    elif count == 1 and torch.is_tensor(noise):
        noise = [noise]
    out = []
    for whole in noise:
        if tuple(whole.shape) != shape:
            raise ValueError(f"noise of shape {tuple(whole.shape)} for latents of global "
                             f"shape {shape}.")
        out.append({d: whole[d * per_block:(d + 1) * per_block].to(device)
                    for (d, _) in _blocks(batch)})
    return out


def _latent_tail(batch):
    (_, height, width, _) = batch.global_shape
    return (height // 16, width // 16, csts.NB_MAPS_3)


def _global_table(state, mesh):
    """The state with the whole density table and bin widths, gathered
    within the model line."""
    nb_maps = state.bin_widths.shape[0] * mesh.size("model") // len(mesh.local_indices("model"))
    return state._replace(
        density=state.density._replace(parameters=gather_model_rows(
            state.density.parameters, mesh, nb_maps)),
        bin_widths=gather_model_rows(state.bin_widths, mesh, nb_maps))


def _own_rows(state, mesh):
    (start, stop) = model_rows(mesh, state.bin_widths.shape[0])
    return state._replace(
        density=state.density._replace(parameters=state.density.parameters[start:stop]),
        bin_widths=state.bin_widths[start:stop])


def _check_batch(batch, mesh):
    batch = split_batch(batch, mesh)
    if batch.spatial:
        raise ValueError("the training step splits batches over `data` only.")
    if batch.global_shape[0] % mesh.size("data"):
        raise ValueError(f"a global batch of {batch.global_shape[0]} images does not divide "
                         f"by the {mesh.size('data')} data shards.")
    return batch


def _noisy_latents_blocks(params, batch, bin_widths, noise, learn_bin_widths):
    ys = {}
    tildes = {}
    for (d, images) in _blocks(batch):
        y = conv_eae.encode(params, images.to(torch.float32), learn_bin_widths)
        ys[d] = y
        tildes[d] = y + bin_widths * noise[d]
    return (ys, tildes)


def _density_phase(state, batch, noise, mesh, learn_bin_widths, ppi, max_itvs):
    """Expansion + one density SGD step + projection, on the global
    batch (traps (a) and (c))."""
    n_procs = mesh.group("data")[1] if mesh.distributed else 1
    with torch.no_grad():
        (ys, tildes) = _noisy_latents_blocks(state.params, batch, state.bin_widths, noise,
                                             learn_bin_widths)
        local_max = torch.stack([torch.max(torch.abs(y)) for y in ys.values()]).max()
        max_abs = _all_reduce(local_max, mesh, dist.ReduceOp.MAX) \
            + 0.5 * torch.max(state.bin_widths)
        table = dens.expand_table(state.density, max_abs, ppi, max_itvs)
        mask = dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs)
    nb_samples = batch.global_shape[0] * math.prod(_latent_tail(batch)[:2])
    parameters = table.parameters.detach().requires_grad_(True)
    with torch.enable_grad():
        sum_prob = sum(torch.sum(dens.approximate_probability(
            _flatten_maps(y_tilde), parameters, ppi, max_itvs), dim=1)
            for y_tilde in tildes.values())
        sum_sq = torch.sum(torch.square(parameters * mask), dim=1)
        loss = torch.sum(-2.0 * sum_prob / nb_samples + sum_sq / (ppi * n_procs))
    (grads,) = torch.autograd.grad(loss, parameters)
    (grads,) = _all_reduce_flat([grads], mesh)
    with torch.no_grad():
        new_parameters = dens.project_density_parameters(
            table.parameters - csts.LR_FCT * grads, mask)
    return state._replace(density=table._replace(parameters=new_parameters))


def _rd_loss(params, bin_widths, batch, noise, density_table, gamma_scaling, mesh,
             learn_bin_widths, ppi, max_itvs):
    """This process's share of the global rate-distortion loss (trap (b)):
    ``(loss, (rec_error, approx_entropy))``, the latter two global."""
    n_procs = mesh.group("data")[1] if mesh.distributed else 1
    (_, tildes) = _noisy_latents_blocks(params, batch, bin_widths, noise, learn_bin_widths)
    (rec_sum, log_sum) = (0.0, 0.0)
    for (d, images) in _blocks(batch):
        y_tilde = tildes[d]
        prob = dens.approximate_probability(_flatten_maps(y_tilde),
                                            density_table.parameters, ppi, max_itvs)
        log_sum = log_sum + torch.sum(-torch.log(prob) / LOG2, dim=1)
        reconstruction = conv_eae.decode(params, y_tilde, learn_bin_widths)
        rec_sum = rec_sum + torch.sum(torch.square(images.to(torch.float32) - reconstruction))
    nb_samples = batch.global_shape[0] * math.prod(_latent_tail(batch)[:2])
    log_sum = _all_reduce_differentiable(log_sum, mesh)
    per_map = log_sum / nb_samples - torch.log(bin_widths) / LOG2
    approx_entropy = torch.sum(torch.clamp_min(per_map, 0.0))
    rec_error = rec_sum / batch.global_shape[0]
    weight_decay = csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norm(params)
    loss = rec_error + (gamma_scaling * approx_entropy + weight_decay) / n_procs
    with torch.no_grad():
        rec_global = _all_reduce(rec_error.detach().clone(), mesh)
    return (loss, (rec_global, approx_entropy.detach()))


def rd_gradients(state, batch, noise, gamma_scaling, mesh, learn_bin_widths, ppi, max_itvs):
    """Gradients of the global rate-distortion loss: ``(grads_params,
    grads_bin_widths, loss)``, all-reduced over the data line; the state
    holds the whole table (see :func:`_global_table`)."""
    params = {name: value.detach().requires_grad_(True)
              for (name, value) in state.params.items()}
    bin_widths = state.bin_widths.detach().requires_grad_(learn_bin_widths)
    with torch.enable_grad():
        (loss, (rec_error, approx_entropy)) = _rd_loss(
            params, bin_widths, batch, noise, state.density, gamma_scaling, mesh,
            learn_bin_widths, ppi, max_itvs)
    names = list(params)
    inputs = [params[name] for name in names] + ([bin_widths] if learn_bin_widths else [])
    grads = _all_reduce_flat(list(torch.autograd.grad(loss, inputs)), mesh)
    grads_bw = grads[len(names)] if learn_bin_widths else None
    full_loss = rec_error + gamma_scaling * approx_entropy + (
        csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norm(state.params))
    return (dict(zip(names, grads)), grads_bw, full_loss.detach())


def _eae_bw_phase(state, batch, noise, gamma_scaling, mesh, learn_bin_widths, ppi, max_itvs):
    (grads_params, grads_bw, _) = rd_gradients(state, batch, noise, gamma_scaling, mesh,
                                               learn_bin_widths, ppi, max_itvs)
    with torch.no_grad():
        (params, opt_eae) = adam_update(grads_params, state.opt_eae, state.params,
                                        gamma_scaling)
        bin_widths = state.bin_widths
        if learn_bin_widths:
            bin_widths = torch.clamp(bin_widths - csts.LR_BW * grads_bw, csts.MIN_BW,
                                     csts.MAX_BW)
        params = _project_gdn(params, learn_bin_widths)
    return state._replace(params=params, bin_widths=bin_widths, opt_eae=opt_eae,
                          step=state.step + 1)


def make_sharded_step_fns(gamma_scaling, learn_bin_widths, mesh, state_template=None,
                          ppi=None, max_itvs=None):
    """Train and evaluation functions over ``mesh``.

    Returns ``{"train_step", "evaluation", "rd_gradients",
    "state_shardings", "batch_sharding"}``:

    - ``train_step(state, batch, noise)``: the state as
      :func:`shard_state` placed it, ``batch`` a
      :class:`parallel.sharding.ShardedBatch` (``distributed.global_batch``)
      or the whole batch, which each process splits; ``noise`` as the
      module says (a pair for the two phases, or a generator);
    - ``evaluation(state, batch, noise)``: the global ``(scaled_ae,
      rec_error, y)``, ``y`` gathered whole on every process;
    - ``rd_gradients(state, batch, noise)``: the global loss's gradients
      and the loss, before any update (for checks);
    - ``state_shardings``: the specs of ``state_template``'s leaves.
    """
    ppi = csts.NB_POINTS_PER_INTERVAL if ppi is None else ppi
    max_itvs = csts.MAX_ITVS_PER_SIDE if max_itvs is None else max_itvs
    static = dict(learn_bin_widths=learn_bin_widths, ppi=ppi, max_itvs=max_itvs)

    def prepare(state, batch, noise, count):
        batch = _check_batch(batch, mesh)
        device = mesh.local_device()
        noises = _noise_blocks(noise, batch, _latent_tail(batch), device, count)
        return (_global_table(state, mesh), batch, noises)

    def train_step(state, batch, noise):
        (state, batch, (noise_fct, noise_eae)) = prepare(state, batch, noise, 2)
        state = _density_phase(state, batch, noise_fct, mesh, **static)
        state = _eae_bw_phase(state, batch, noise_eae, gamma_scaling, mesh, **static)
        return _own_rows(state, mesh)

    def gradients(state, batch, noise):
        (state, batch, (noise_eae,)) = prepare(state, batch, noise, 1)
        return rd_gradients(state, batch, noise_eae, gamma_scaling, mesh, **static)

    @torch.no_grad()
    def evaluation(state, batch, noise):
        (state, batch, (noise_eval,)) = prepare(state, batch, noise, 1)
        (ys, tildes) = _noisy_latents_blocks(state.params, batch, state.bin_widths,
                                             noise_eval, learn_bin_widths)
        (rec_sum, log_sum) = (0.0, 0.0)
        for (d, images) in _blocks(batch):
            prob = dens.approximate_probability(_flatten_maps(tildes[d]),
                                                state.density.parameters, ppi, max_itvs)
            log_sum = log_sum + torch.sum(-torch.log(prob) / LOG2, dim=1)
            reconstruction = conv_eae.decode(state.params, tildes[d], learn_bin_widths)
            rec_sum = rec_sum + torch.sum(torch.square(images.to(torch.float32)
                                                       - reconstruction))
        nb_samples = batch.global_shape[0] * math.prod(_latent_tail(batch)[:2])
        log_sum = _all_reduce(log_sum, mesh)
        rec_sum = _all_reduce(rec_sum, mesh)
        per_map = log_sum / nb_samples - torch.log(state.bin_widths) / LOG2
        scaled_ae = gamma_scaling * torch.sum(torch.clamp_min(per_map, 0.0))
        y = ShardedBatch(mesh, {(d, None): y for (d, y) in ys.items()},
                         (batch.global_shape[0],) + _latent_tail(batch)).gather()
        return (scaled_ae, rec_sum / batch.global_shape[0], y)

    return {"train_step": train_step, "evaluation": evaluation, "rd_gradients": gradients,
            "state_shardings": (state_shardings(mesh, state_template)
                                if state_template is not None else None),
            "batch_sharding": batch_sharding(mesh)}
