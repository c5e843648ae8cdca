"""Whole-RD-ladder training: every gamma trained in one program.

The reference's flagship study trains ONE model per rate point (gamma in
{10k..96k}, ``reconstructing_eae_kodak.py:607-611``), each a separate
``training_eae_imagenet.py`` run. Here the whole one-model-per-gamma
family trains together: the training state is stacked along a leading
ladder axis, every mini-batch is shared across the ladder (every
reference run consumes the same training set) and the uniform
quantisation noise is drawn per model. A ladder step is the model-axis
step of ``train/step.py`` (:class:`train.step.ModelAxisStep`), one
program over all the models, the counterpart of the JAX ladder's
``vmap`` of the single-model step; on the card an epoch is the replays
of one captured ladder step, on the CPU the loop of ladder steps. The
ladder family is the fixed-bin-width architecture
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

**Noise** is given as ``train/step.py`` says: a generator, or one
entry per model. A generator's ``(M, *latent)`` draw a phase is not the
order of the loop over single models that the ladder was before (each
model's two phases in turn), so a generator's numbers land on other
models and phases than they did there. A sharded ladder's epoch runs
block after block (block ``i``'s whole epoch, then block ``i + 1``'s),
eagerly or graphed, so blocks that share a generator draw in that order.
"""

from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.train.state import (
    TrainState,
    init_train_state,
    map_state,
)
from autoencoder_based_image_compression_tpu_torch.train.step import ModelAxisStep, _per_model


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
    whole = ModelAxisStep(gammas, False, ppi, max_itvs)
    blocks = {}

    def block_fns(states, i):
        """Block ``i``'s stacked functions and its models, as a slice."""
        per = states.per_shard
        if (i, per) not in blocks:
            blocks[(i, per)] = ModelAxisStep(gammas[i * per:(i + 1) * per], False, ppi,
                                             max_itvs)
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
    return ModelAxisStep(gammas, False, ppi, max_itvs).evaluation
