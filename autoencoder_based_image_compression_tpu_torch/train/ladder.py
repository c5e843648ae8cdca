"""Whole-RD-ladder training: every gamma trained in one program.

The reference's flagship study trains ONE model per rate point (gamma in
{10k..96k}, ``reconstructing_eae_kodak.py:607-611``), each a separate
``training_eae_imagenet.py`` run. Here the whole one-model-per-gamma
family trains together: the training state is stacked along a leading
ladder axis, every mini-batch is shared across the ladder (every
reference run consumes the same training set) and the uniform
quantisation noise is drawn per model.

A ladder step is a Python loop over the models: model ``k`` takes the
single-model ``train_step`` of :func:`train.step.make_step_fns` at its
own gamma (loss scale and learning-rate boundaries,
``EntropyAutoencoder.py:235-243``) on slice ``k`` of every stacked leaf.
The slices are contiguous views, so every GDN site still launches the
hand-written kernel, which a batching transform over the models could
not do. Stacking the seven states again after a step copies them once
(under 1 % of the step on an H100). Nothing in a step reads a value back
to the host, so on the card an epoch is the replays of one captured
ladder step (``train/epoch_graph.py``, the counterpart of the JAX
ladder's scanned epoch); on the CPU, and for a sharded ladder, it is
the loop of ladder steps. The learning
rate is ``LR_EAE`` times 0.1 from each boundary on
(``train.state.learning_rate``).

The ladder family is the fixed-bin-width architecture
(``learn_bin_widths=False``): the bin widths stay at their init.

``ladder_slice_state`` exports one ladder entry as a standard
:class:`TrainState`, so checkpoints, statistics collection and the RD
evaluation consume ladder-trained models unchanged.

``shard_ladder_state`` spreads the models over a mesh axis: each shard
holds a contiguous run of models and its ladder step is the same loop
over its own models only, with no communication (the models are
independent). ``parallel.distributed.fetch_replicated`` stacks the
ladder again.

**Noise.** Where the reference takes a random key, these functions take
``noise``: a ``torch.Generator`` on the state's device (drawn from per
model, in model order, density phase first), or the noise itself, one
entry per model: a tensor for ``training_fct`` and ``evaluation``, a
pair ``(noise_fct, noise_eae)`` for ``train_step``.
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import GraphedEpoch
from autoencoder_based_image_compression_tpu_torch.train.state import (
    TrainState,
    init_train_state,
    map_state,
)
from autoencoder_based_image_compression_tpu_torch.train.step import (
    _rd_loss,
    epoch_over_rows,
    make_step_fns,
)


def ladder_stack_states(states):
    """Stacks single-model :class:`TrainState`s into a ladder state: every
    leaf gains a leading axis of ``len(states)``. Inverse of
    :func:`ladder_slice_state` (used to resume a ladder part from the
    per-model checkpoints of the previous part)."""
    return map_state(lambda *leaves: torch.stack(leaves, dim=0), *states)


def _unstack(ladder_states):
    """The ladder's entries as single-model states whose leaves are views
    of the stacked leaves (contiguous and 16-byte aligned, as the kernel
    wrappers require)."""
    nb_models = ladder_states.step.shape[0]
    return [map_state(lambda leaf, k=k: leaf[k], ladder_states) for k in range(nb_models)]


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
    """``noise`` as one entry per model."""
    if isinstance(noise, torch.Generator):
        return [noise] * nb_models
    if len(noise) != nb_models:
        raise ValueError(f"{len(noise)} noises for {nb_models} models.")
    return list(noise)


def make_ladder_step_fns(gammas, ppi=csts.NB_POINTS_PER_INTERVAL,
                         max_itvs=csts.MAX_ITVS_PER_SIDE):
    """Whole-ladder training functions.

    Returns ``{"training_fct", "train_step", "train_epoch"}``, the
    ladder counterparts of :func:`train.step.make_step_fns`'s entries
    (fixed-bin-width architecture). Each takes and returns the stacked
    state, or the :class:`LadderShards` of :func:`shard_ladder_state`
    (each block runs the loop over its own models).
    """
    singles = [make_step_fns(gamma, False, ppi=ppi, max_itvs=max_itvs) for gamma in gammas]

    def over_models(name):
        def loop(models, states, batch, noises):
            return ladder_stack_states([
                fns[name](state, batch, noise_k)
                for (fns, state, noise_k) in zip(models, _unstack(states), noises)])

        def fn(states, batch, noise):
            noises = _per_model(noise, len(singles))
            if not isinstance(states, LadderShards):
                return loop(singles, states, batch, noises)
            per = states.per_shard

            def block_step(i, block):
                device = block.step.device
                block_noises = [n if isinstance(n, torch.Generator) else (
                    tuple(t.to(device) for t in n) if isinstance(n, (tuple, list))
                    else n.to(device)) for n in noises[i * per:(i + 1) * per]]
                return loop(singles[i * per:(i + 1) * per], block, batch.to(device),
                            block_noises)

            return states.map_blocks(block_step)
        return fn

    training_fct = over_models("training_fct")
    train_step = over_models("train_step")

    graphed_epoch = GraphedEpoch(train_step)

    def train_epoch(states, dataset, rows, noise):
        # A sharded ladder's blocks may sit on several devices: its epoch
        # stays the eager loop.
        if not isinstance(states, LadderShards) and states.step.is_cuda:
            return graphed_epoch(states, dataset, rows, noise)
        return epoch_over_rows(train_step, states, dataset, rows, noise)

    return {
        "training_fct": training_fct,
        "train_step": train_step,
        "train_epoch": train_epoch,
    }


def make_ladder_eval_fn(gammas, ppi=csts.NB_POINTS_PER_INTERVAL,
                        max_itvs=csts.MAX_ITVS_PER_SIDE):
    """Per-model training indicators on a shared eval batch.

    Returns ``evaluation(states, batch, noise) -> (rec_errors,
    approx_entropies)`` of shape (K,) each (the noise-perturbed RD-loss
    components, reference ``EntropyAutoencoder.py:542-589``'s core
    indicators over the ladder)."""

    @torch.no_grad()
    def evaluation(states, batch, noise):
        models = _unstack(states)
        pairs = [_rd_loss(state.params, state.bin_widths, batch, noise_k, state.density,
                          gamma, False, ppi, max_itvs)[1]
                 for (state, gamma, noise_k) in zip(models, gammas,
                                                    _per_model(noise, len(models)))]
        return (torch.stack([rec for (rec, _) in pairs]),
                torch.stack([ent for (_, ent) in pairs]))

    return evaluation
