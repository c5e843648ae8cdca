"""Whole-RD-ladder training: every gamma trained in one program.

The reference's flagship study trains ONE model per rate point (gamma in
{10k..96k}, ``reconstructing_eae_kodak.py:607-611``), each a separate
``training_eae_imagenet.py`` run. Here the whole one-model-per-gamma
family trains together: the training state is stacked along a leading
ladder axis, every mini-batch is shared across the ladder (every
reference run consumes the same training set) and the uniform
quantisation noise is drawn per model.

A ladder step is one program over all the models, the counterpart of the
JAX ladder's ``vmap`` of the single-model step. The models' maps sit
side by side in the channels (``models/conv_eae.py::encode_stacked``,
``decode_stacked``): every convolution is grouped over the models (the
first one is one conv with M * 128 outputs of the shared batch), every
GDN site is one launch of the stacked fp32 kernel, and the density
model, the projections and Adam run once over the stacked leaves. The
loss is the sum over the models of each model's ``rec_error + gamma_k *
approx_entropy + weight_decay`` (``EntropyAutoencoder.py:308-313``): the
models share no parameter, so one backward pass gives each its own
gradient. The learning rate is ``LR_EAE`` times 0.1 from each of the
model's gamma-keyed boundaries on (``train.state.learning_rate``, the
JAX ladder's ``_lr``). Nothing in a step reads a value back to the
host, so on the card an epoch is the replays of one captured ladder
step (``train/epoch_graph.py``, the counterpart of the JAX ladder's
scanned epoch); on the CPU it is the loop of ladder steps.

The ladder family is the fixed-bin-width architecture
(``learn_bin_widths=False``): the bin widths stay at their init.

``ladder_slice_state`` exports one ladder entry as a standard
:class:`TrainState`, so checkpoints, statistics collection and the RD
evaluation consume ladder-trained models unchanged.

``shard_ladder_state`` spreads the models over a mesh axis: each shard
holds a contiguous block of models, a stacked ladder of its own, and runs
the same stacked step with no communication (the models are
independent); its epoch is graphed on its device as the unsharded
ladder's is. ``parallel.distributed.fetch_replicated`` stacks the ladder
again.

**Noise.** Where the reference takes a random key, these functions take
``noise``: a ``torch.Generator`` on the state's device, or the noise
itself, one entry per model (a tensor of the latents' shape for
``training_fct`` and ``evaluation``, a pair ``(noise_fct, noise_eae)``
for ``train_step``). Given per model, it is stacked and each model gets
its own entry. From a generator, each phase draws ``(M, *latent)`` at
once, model ``m``'s noise being entry ``m``, the density phase first;
this is not the order of the loop over single models that the ladder was
before (each model's two phases in turn), so a generator's numbers land
on other models and phases than they did there. A sharded ladder's epoch
runs block after block (block ``i``'s whole epoch, then block ``i + 1``'s),
eagerly or graphed, so blocks that share a generator draw in that order.
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.train.state import (
    TrainState,
    adam_update,
    init_train_state,
    ladder_boundaries,
    map_state,
)
from autoencoder_based_image_compression_tpu_torch.train.step import _leaves, _project_gdn
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase


def ladder_stack_states(states):
    """Stacks single-model :class:`TrainState`s into a ladder state: every
    leaf gains a leading axis of ``len(states)``. Inverse of
    :func:`ladder_slice_state` (used to resume a ladder part from the
    per-model checkpoints of the previous part)."""
    return map_state(lambda *leaves: torch.stack(leaves, dim=0), *states)


def ladder_slice_state(ladder_states, idx, gamma=None):
    """Extracts ladder entry ``idx`` as a standard :class:`TrainState`
    that shares no memory with the ladder. ``gamma`` is accepted for the
    reference's signature; Adam's state here holds no schedule, so
    nothing depends on it."""
    return map_state(lambda leaf: leaf[idx].clone(), ladder_states)


def init_ladder_state(generator, gammas, bin_width_init=1.0,
                      ppi=csts.NB_POINTS_PER_INTERVAL, max_itvs=csts.MAX_ITVS_PER_SIDE,
                      nb_itvs_init=csts.NB_ITVS_PER_SIDE_INIT, device="cuda"):
    """Stacked TrainState over the gamma ladder (leading axis = model).
    Each model draws its own initial parameters from ``generator``, in
    ladder order."""
    return ladder_stack_states([
        init_train_state(generator, bin_width_init, False, ppi=ppi, max_itvs=max_itvs,
                         nb_itvs_init=nb_itvs_init, device=device)
        for _ in gammas])


class LadderShards(NamedTuple):
    """A ladder spread over a mesh axis (:func:`shard_ladder_state`).

    ``blocks[i]`` is the stacked state of models ``[i * per_shard, (i + 1)
    * per_shard)`` on the device of this process's entry at index ``i``
    of ``axis``; only this process's indices are here.
    """

    mesh: object
    axis: str
    nb_models: int
    blocks: Dict[int, TrainState]

    @property
    def per_shard(self):
        return self.nb_models // self.mesh.size(self.axis)

    def map_blocks(self, fn):
        """The ladder whose every block ``i`` is ``fn(i, block)``."""
        return self._replace(blocks={i: fn(i, block) for (i, block) in self.blocks.items()})

    def fetch(self):
        """The whole stacked ladder on the host (CPU tensors), every
        process's blocks included."""
        from autoencoder_based_image_compression_tpu_torch.parallel.distributed import (
            all_gather_objects,
        )

        local = {i: map_state(lambda leaf: leaf.detach().cpu(), block)
                 for (i, block) in self.blocks.items()}
        merged = {}
        for other in all_gather_objects(local, self.mesh):
            merged.update(other)
        return map_state(lambda *leaves: torch.cat(leaves, dim=0),
                         *[merged[i] for i in range(self.mesh.size(self.axis))])


def shard_ladder_state(ladder_states, mesh, axis="data"):
    """Spreads the ladder (leading) axis of every leaf over a mesh axis.

    Model parallelism over the gammas: each shard trains its own
    contiguous run of models with no communication, so the study scales
    with the shards. The number of models must divide the axis size
    (pad the gamma list otherwise). The step functions of
    :func:`make_ladder_step_fns` take the result as they take a stacked
    state, and return it so.
    """
    nb_models = int(ladder_states.step.shape[0])
    size = mesh.size(axis)
    if nb_models % size:
        raise ValueError(f"{nb_models} ladder models do not divide over the {size} shards "
                         f"of the {axis!r} axis (pad the gamma list).")
    per = nb_models // size
    blocks = {i: map_state(lambda leaf, i=i: leaf[i * per:(i + 1) * per].to(
        mesh.device_of(axis, i)).clone(), ladder_states)
        for i in mesh.local_indices(axis)}
    return LadderShards(mesh, axis, nb_models, blocks)


def _per_model(noise, nb_models):
    """``noise`` checked to be a generator or one entry per model."""
    if not isinstance(noise, torch.Generator) and len(noise) != nb_models:
        raise ValueError(f"{len(noise)} noises for {nb_models} models.")
    return noise


def _stacked_noise(noise, y):
    """Uniform noise in [-0.5, 0.5) laid out as the stacked latents ``y``
    (``(B, h, w, M * 128)``): drawn as ``(M, B, h, w, 128)`` from a
    generator, or the M given tensors stacked."""
    (batch, height, width, channels) = y.shape
    nb_models = channels // csts.NB_MAPS_3
    if isinstance(noise, torch.Generator):
        drawn = torch.rand((nb_models, batch, height, width, csts.NB_MAPS_3), generator=noise,
                           device=y.device, dtype=y.dtype) - 0.5
    else:
        drawn = torch.stack([n.to(device=y.device) for n in noise])
        if drawn.shape[1:] != (batch, height, width, csts.NB_MAPS_3):
            raise ValueError(f"noise of shape {tuple(drawn.shape[1:])} for latents of shape "
                             f"{(batch, height, width, csts.NB_MAPS_3)}.")
    return drawn.permute(1, 2, 3, 0, 4).reshape(y.shape)


def _flatten_maps_stacked(y_tilde, nb_models):
    """(B, h, w, M * C) -> (M, C, B*h*w): row ``(m, i)`` gathers every
    sample of model ``m``'s map ``i`` (``train.step._flatten_maps`` per
    model)."""
    return y_tilde.reshape(-1, nb_models, y_tilde.shape[-1] // nb_models).permute(1, 2, 0)


def _expanded_tables(states, y, ppi, max_itvs):
    """The density tables grown to hold each model's latents, and their
    masks; each model's largest latent stays on the device."""
    nb_models = states.step.shape[0]
    max_abs = (y.reshape(-1, nb_models, y.shape[-1] // nb_models).abs().amax(dim=(0, 2))
               + 0.5 * states.bin_widths.amax(dim=-1))
    table = dens.expand_table(states.density, max_abs, ppi, max_itvs)
    return (table, dens.active_mask(table.nb_itvs_per_side, ppi, max_itvs))


def _density_update_stacked(states, y, noise, ppi, max_itvs):
    """``train.step._density_update`` of every model at once on the
    stacked latents ``y``: the expansion, one SGD step on the sum of the
    models' density losses (each model's table gets its own gradient) and
    the projection; the noise is drawn here."""
    nb_models = states.step.shape[0]
    with torch.no_grad():
        y_tilde = y + states.bin_widths.reshape(-1) * _stacked_noise(noise, y)
        (table, mask) = _expanded_tables(states, y, ppi, max_itvs)
        samples = _flatten_maps_stacked(y_tilde, nb_models)
    parameters = table.parameters.detach().requires_grad_(True)
    with torch.enable_grad():
        prob = dens.approximate_probability(samples, parameters, ppi, max_itvs)
        loss = torch.sum(dens.loss_density_approximation(prob, parameters, mask, ppi))
    (grads,) = torch.autograd.grad(loss, parameters)
    with torch.no_grad():
        new_parameters = dens.project_density_parameters(
            table.parameters - csts.LR_FCT * grads, mask)
    return states._replace(density=table._replace(parameters=new_parameters))


def _rd_loss_stacked(params, states, visible_units, y, noise, gammas, ppi, max_itvs):
    """``train.step._rd_loss`` of every model at once, from the float32
    batch's stacked latents ``y``: ``(sum over the models of rec_error +
    gamma * approx_entropy + weight_decay, (rec_errors,
    approx_entropies))``, the last two ``(M,)``; the noise is drawn here."""
    nb_models = states.step.shape[0]
    y_tilde = y + states.bin_widths.reshape(-1) * _stacked_noise(noise, y)
    prob = dens.approximate_probability(_flatten_maps_stacked(y_tilde, nb_models),
                                        states.density.parameters, ppi, max_itvs)
    approx_entropy = dens.approximate_entropy(prob, states.bin_widths)
    reconstruction = conv_eae.decode_stacked(params, y_tilde, False)
    rec_error = torch.mean(torch.sum(torch.square(visible_units - reconstruction), dim=(1, 2)),
                           dim=0)
    weight_decay = csts.WEIGHT_DECAY_P * conv_eae.weight_l2_norms(params)
    loss = rec_error + gammas * approx_entropy + weight_decay
    return (torch.sum(loss), (rec_error, approx_entropy))


class _StackedLadder:
    """The stacked step functions of the models ``gammas``: a whole
    ladder, or one block of a sharded one."""

    def __init__(self, gammas, ppi, max_itvs):
        (self.gammas, self.ppi, self.max_itvs) = (list(gammas), ppi, max_itvs)
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
        noise = _per_model(noise, len(self.gammas))
        with phase("density"):
            with torch.no_grad():
                y = conv_eae.encode_stacked(states.params, batch.to(torch.float32), False)
            return _density_update_stacked(states, y, noise, self.ppi, self.max_itvs)

    def _autoencoder_phase(self, states, params, batch, y, noise):
        """One Adam step of every model on the sum of their losses, then
        the GDN projections (``train.step._eae_bw_update`` with fixed bin
        widths), in the phases ``forward``, ``backward`` and
        ``optimizer``. ``params`` are the autograd leaves of
        ``states.params`` and ``y`` the batch's latents under them, or
        ``None`` to encode the batch here."""
        (gammas, boundaries) = self.constants(states.step.device)
        with phase("forward"), torch.enable_grad():
            batch = batch.to(torch.float32)
            if y is None:
                y = conv_eae.encode_stacked(params, batch, False)
            (loss, _) = _rd_loss_stacked(params, states, batch, y, noise, gammas, self.ppi,
                                         self.max_itvs)
        names = list(params)
        with phase("backward"):
            grads = torch.autograd.grad(loss, [params[name] for name in names])
        with phase("optimizer"), torch.no_grad():
            (new_params, opt_eae) = adam_update(dict(zip(names, grads)), states.opt_eae,
                                                states.params, boundaries)
            new_params = _project_gdn(new_params, False)
        return states._replace(params=new_params, opt_eae=opt_eae, step=states.step + 1)

    def training_eae(self, states, batch, noise):
        """The autoencoder phase alone, which encodes the batch itself."""
        (params, _) = _leaves(states, False)
        return self._autoencoder_phase(states, params, batch, None, noise)

    def train_step(self, states, batch, noise):
        # One generator serves both phases in turn, the density phase first.
        if isinstance(noise, torch.Generator):
            (noise_fct, noise_eae) = (noise, noise)
        else:
            _per_model(noise, len(self.gammas))
            (noise_fct, noise_eae) = ([pair[0] for pair in noise], [pair[1] for pair in noise])
        # One encode serves both phases: the density phase changes only the
        # tables, which the encoder never reads.
        (params, _) = _leaves(states, False)
        with phase("density"):
            batch = batch.to(torch.float32)
            with torch.enable_grad():
                y = conv_eae.encode_stacked(params, batch, False)
            states = _density_update_stacked(states, y.detach(), noise_fct, self.ppi,
                                             self.max_itvs)
        return self._autoencoder_phase(states, params, batch, y, noise_eae)

    @torch.no_grad()
    def evaluation(self, states, batch, noise):
        (gammas, _) = self.constants(states.step.device)
        batch = batch.to(torch.float32)
        y = conv_eae.encode_stacked(states.params, batch, False)
        (_, indicators) = _rd_loss_stacked(states.params, states, batch, y,
                                           _per_model(noise, len(self.gammas)), gammas,
                                           self.ppi, self.max_itvs)
        return indicators


def _block_noise(noise, models, device):
    """Block ``models`` (a slice) of one per-model noise, on ``device``; a
    generator as it is."""
    if isinstance(noise, torch.Generator):
        return noise
    return [tuple(t.to(device) for t in n) if isinstance(n, (tuple, list)) else n.to(device)
            for n in noise[models]]


def make_ladder_step_fns(gammas, ppi=csts.NB_POINTS_PER_INTERVAL,
                         max_itvs=csts.MAX_ITVS_PER_SIDE):
    """Whole-ladder training functions.

    Returns ``{"training_fct", "train_step", "fit_epoch",
    "train_epoch"}``, the ladder counterparts of
    :func:`train.step.make_step_fns`'s entries (fixed-bin-width
    architecture), each one program over the stacked state. Each takes
    and returns the stacked state, or the :class:`LadderShards` of
    :func:`shard_ladder_state` (each block runs the stacked functions of
    its own models). ``fit_epoch`` and ``train_epoch`` on a CUDA state
    replay one captured ladder ``training_fct`` / ``train_step`` a batch,
    a block's on that block's device for a sharded ladder, block after
    block, and loop on the CPU; their ``phase_ms()`` reads the stamps of
    the whole ladder's last graphed epoch (``train/epoch_graph.py``).
    """
    whole = _StackedLadder(gammas, ppi, max_itvs)
    blocks = {}

    def block_fns(states, i):
        """Block ``i``'s stacked functions and its models, as a slice."""
        per = states.per_shard
        if (i, per) not in blocks:
            blocks[(i, per)] = _StackedLadder(gammas[i * per:(i + 1) * per], ppi, max_itvs)
        return (blocks[(i, per)], slice(i * per, (i + 1) * per))

    def over_blocks(name):
        def fn(states, batch, noise):
            _per_model(noise, len(gammas))
            if not isinstance(states, LadderShards):
                return getattr(whole, name)(states, batch, noise)

            def block_step(i, block):
                (fns, models) = block_fns(states, i)
                device = block.step.device
                return getattr(fns, name)(block, batch.to(device),
                                          _block_noise(noise, models, device))

            return states.map_blocks(block_step)
        return fn

    def over_epochs(name):
        def fn(states, dataset, rows, noise):
            if not isinstance(states, LadderShards):
                return getattr(whole, name)(states, dataset, rows, noise)

            # Block after block, each block's whole epoch on its device.
            def block_epoch(i, block):
                (fns, models) = block_fns(states, i)
                device = block.step.device
                block_noise = noise if isinstance(noise, torch.Generator) else [
                    _block_noise(batch_noise, models, device) for batch_noise in noise]
                return getattr(fns, name)(block, dataset.to(device), rows, block_noise)

            return states.map_blocks(block_epoch)

        # The whole ladder's graphed epochs (a sharded ladder's blocks keep theirs).
        fn.phase_ms = getattr(whole, name).phase_ms
        return fn

    return {
        "training_fct": over_blocks("training_fct"),
        "train_step": over_blocks("train_step"),
        "fit_epoch": over_epochs("fit_epoch"),
        "train_epoch": over_epochs("train_epoch"),
    }


def make_ladder_eval_fn(gammas, ppi=csts.NB_POINTS_PER_INTERVAL,
                        max_itvs=csts.MAX_ITVS_PER_SIDE):
    """Per-model training indicators on a shared eval batch.

    Returns ``evaluation(states, batch, noise) -> (rec_errors,
    approx_entropies)`` of shape (K,) each (the noise-perturbed RD-loss
    components, reference ``EntropyAutoencoder.py:542-589``'s core
    indicators over the ladder), one pass over every model."""
    return _StackedLadder(gammas, ppi, max_itvs).evaluation
