"""Where each piece of the training state and of a batch lives on a mesh.

Counterpart of the reference's ``parallel/sharding.py``. The port has no
``NamedSharding``: a leaf's spec is one of three words, which
:func:`shard_state`, :func:`place` and :func:`fetch` read.

- ``"replicated"``: every process holds the whole leaf. Weights and the
  Adam moments (1.76M parameters: replication costs less than any
  gather).
- ``"model"``: split by rows over the ``model`` axis. The density table
  ``(nb_maps, W)`` and the bin widths: their math is per map. A process
  holds the rows of its model positions, a contiguous run.
- ``"data"``: split by images over the ``data`` axis. Batches, as a
  :class:`ShardedBatch`.
"""

import numpy
import torch
import torch.distributed as dist

from autoencoder_based_image_compression_tpu_torch.train.state import TrainState, map_state

REPLICATED = "replicated"
DATA = "data"
MODEL = "model"


def replicated(mesh=None):
    return REPLICATED


def batch_sharding(mesh=None):
    """NHWC image batches split over the leading (batch) axis."""
    return DATA


def density_sharding(mesh=None):
    """Density table (nb_maps, W): map rows split over ``model``."""
    return MODEL


def bin_widths_sharding(mesh=None):
    return MODEL


def state_shardings(mesh, state):
    """A :class:`TrainState` of specs matching ``state``: everything
    replicated but the density parameters and the bin widths, split per
    map over ``model``."""
    specs = map_state(lambda leaf: REPLICATED, state)
    return specs._replace(
        density=specs.density._replace(parameters=density_sharding(mesh)),
        bin_widths=bin_widths_sharding(mesh))


class ShardedBatch:
    """This process's pieces of a batch laid over a mesh.

    ``pieces[(d, m)]`` is the tensor at grid position ``(d, m)``, on
    that entry's device: the images of data block ``d`` and, when
    ``spatial``, the rows of height block ``m`` (``m`` is None for a
    batch split over ``data`` alone, which every model position of the
    row shares). ``global_shape`` is the shape of the whole batch.
    """

    def __init__(self, mesh, pieces, global_shape, spatial=False):
        self.mesh = mesh
        self.pieces = dict(sorted(pieces.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)))
        self.global_shape = tuple(global_shape)
        self.spatial = spatial

    def with_pieces(self, pieces):
        """A batch laid out alike whose pieces are ``pieces`` (same
        positions; each piece's shape sets the whole's)."""
        (old, new) = (next(iter(self.pieces.values())).shape, next(iter(pieces.values())).shape)
        shape = tuple(g // o * n for (g, o, n) in zip(self.global_shape, old, new))
        return ShardedBatch(self.mesh, pieces, shape, self.spatial)

    def map(self, fn):
        """The batch whose every piece is ``fn(piece)``."""
        return self.with_pieces({pos: fn(piece) for (pos, piece) in self.pieces.items()})

    def map_blocks(self, whole_fn, bands_fn):
        """A transform over the pieces: ``whole_fn(piece)`` on each data
        block, or, when ``spatial``, ``bands_fn(bands, d)`` on the
        ``{m: band}`` of each data block, which returns ``{m: out}``."""
        if not self.spatial:
            return self.map(whole_fn)
        pieces = {}
        for d in sorted({d for (d, _) in self.pieces}):
            for (m, out) in bands_fn(dict(self.rows(d)), d).items():
                pieces[(d, m)] = out
        return self.with_pieces(pieces)

    def rows(self, d):
        """The pieces of data block ``d`` held here, in height order."""
        return [(pos[1], piece) for (pos, piece) in self.pieces.items() if pos[0] == d]

    def local_sum(self):
        """Sum of every local piece, as one scalar tensor (a checksum
        that reads no piece back to the host)."""
        sums = [piece.sum() for piece in self.pieces.values()]
        device = sums[0].device
        return torch.stack([s.to(device) for s in sums]).sum()

    def gather(self, device=None):
        """The whole batch as one tensor on ``device`` (default: the
        first local piece's), every process's pieces included."""
        device = device or next(iter(self.pieces.values())).device
        pieces = gather_pieces(self.pieces, self.mesh)
        rows = []
        for d in range(self.mesh.size("data")):
            parts = [pieces[pos] for pos in sorted(p for p in pieces if p[0] == d)
                     ] if self.spatial else [pieces[(d, None)]]
            rows.append(torch.cat([p.to(device) for p in parts], dim=1))
        return torch.cat(rows, dim=0)


def gather_pieces(pieces, mesh):
    """Every process's ``{key: tensor or array}`` pieces, merged (the
    tensors of other processes arrive on the CPU)."""
    if not mesh.distributed:
        return dict(pieces)
    from autoencoder_based_image_compression_tpu_torch.parallel.distributed import (
        all_gather_objects,
    )

    def host(value):
        return value.detach().cpu() if torch.is_tensor(value) else value

    merged = {}
    for other in all_gather_objects({key: host(v) for (key, v) in pieces.items()}, mesh):
        merged.update(other)
    merged.update(pieces)
    return merged


def split_batch(batch, mesh, spatial=False):
    """A whole batch (host or device tensor, or numpy) as this process's
    :class:`ShardedBatch`: images split over ``data`` and, when
    ``spatial``, rows over ``model``. Raises unless each split is even."""
    if isinstance(batch, ShardedBatch):
        return batch
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(numpy.ascontiguousarray(batch))
    (n_data, n_model) = (mesh.size("data"), mesh.size("model"))
    if batch.shape[0] % n_data:
        raise ValueError(f"a batch of {batch.shape[0]} images does not split evenly over "
                         f"the {n_data} data shards of the mesh.")
    per_block = batch.shape[0] // n_data
    pieces = {}
    if spatial:
        if batch.shape[1] % n_model or (batch.shape[1] // n_model) % 16:
            raise ValueError(f"a height of {batch.shape[1]} does not split over {n_model} "
                             "model shards in multiples of 16 rows (the total stride).")
        rows = batch.shape[1] // n_model
        for (d, m) in mesh.local_positions():
            pieces[(d, m)] = batch[d * per_block:(d + 1) * per_block,
                                   m * rows:(m + 1) * rows].contiguous().to(
                mesh.entry_device(d, m))
    else:
        for d in mesh.local_indices("data"):
            pieces[(d, None)] = batch[d * per_block:(d + 1) * per_block].to(
                mesh.device_of("data", d))
    return ShardedBatch(mesh, pieces, batch.shape, spatial)


def model_rows(mesh, nb_rows):
    """``(start, stop)`` of the rows this process holds of a leaf of
    ``nb_rows`` split over ``model``."""
    n_model = mesh.size("model")
    if nb_rows % n_model:
        raise ValueError(f"{nb_rows} maps do not split over {n_model} model shards.")
    per = nb_rows // n_model
    held = mesh.local_indices("model")
    if held != list(range(held[0], held[-1] + 1)):
        raise ValueError(f"this process's model positions {held} are not contiguous.")
    return (held[0] * per, (held[-1] + 1) * per)


def gather_model_rows(local, mesh, nb_rows):
    """The whole leaf from this process's rows: an all-gather within
    the process's ``model`` line (nothing when it holds every row)."""
    if local.shape[0] == nb_rows:
        return local
    (group, size) = mesh.group(MODEL)
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)  # group ranks ascend with the model positions


def place(value, spec, mesh):
    """``value`` (the whole leaf) as this process holds it under ``spec``."""
    if spec == DATA:
        return split_batch(value, mesh)
    device = mesh.local_device()
    if spec == MODEL:
        (start, stop) = model_rows(mesh, value.shape[0])
        return value[start:stop].to(device).clone()
    return value.to(device)


def shard_state(state, mesh):
    """Places a host-built :class:`TrainState` onto the mesh with its
    shardings: each process keeps its own rows of the leaves split over
    ``model``, and the rest whole, on its device."""
    specs = state_shardings(mesh, state)
    return map_state(lambda leaf, spec: place(leaf, spec, mesh), state, specs)


def fetch(tree, mesh=None):
    """See ``parallel.distributed.fetch_replicated``."""
    from autoencoder_based_image_compression_tpu_torch.train.ladder import LadderShards

    if isinstance(tree, LadderShards):
        return tree.fetch()
    if isinstance(tree, ShardedBatch):
        return tree.gather().cpu()
    if isinstance(tree, TrainState) and mesh is not None:
        share = mesh.size(MODEL) // len(mesh.local_indices(MODEL))

        def leaf(value, spec):
            if spec == MODEL:
                value = gather_model_rows(value, mesh, value.shape[0] * share)
            return value.detach().cpu()

        return map_state(leaf, tree, state_shardings(mesh, tree))
    if isinstance(tree, dict):
        return {key: fetch(value, mesh) for (key, value) in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fetch(value, mesh) for value in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(fetch(value, mesh) for value in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree
