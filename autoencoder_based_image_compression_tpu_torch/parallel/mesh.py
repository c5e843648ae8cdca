"""Device meshes: a ``(data, model)`` grid of shards.

Counterpart of the reference's ``parallel/mesh.py``. Axis convention:

- ``data``: image-batch data parallelism (batches split by image);
- ``model``: latent-map parallelism (the density table's rows and the
  bin widths split per map) and, in height-sharded inference, the image
  height.

A :class:`Mesh` is a grid whose every entry is a ``(rank, device)``
pair: the process that holds the shard and the device it runs on. A
process runs its own entries in turn. A one-process mesh may name one
device several times (``["cpu"] * 8``, ``["cuda:0", "cuda:0"]``): its
shards then run one after the other on that device, which is how the
tests stand in for several devices and how one card puts two height
shards of one image through the kernels. A mesh whose entries belong to
several processes (``parallel.distributed``) holds one
``torch.distributed`` group per axis line, made once here.
"""

import numpy
import torch

AXES = ("data", "model")


def mesh_shape_for(nb_devices, model_parallelism=1):
    """(data, model) shape using every device."""
    if nb_devices % model_parallelism != 0:
        raise ValueError(
            f"{nb_devices} devices are not divisible by model_parallelism="
            f"{model_parallelism}.")
    return (nb_devices // model_parallelism, model_parallelism)


def _process_rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A ``(data, model)`` grid of ``(rank, device)`` entries.

    ``distributed`` says whether the shards' processes talk through
    ``torch.distributed``; then every process of the mesh builds the same
    mesh, and each axis line whose processes are more than this one gets
    a process group (the whole world's group when the line spans it, so
    that a world of one still runs its collectives).
    """

    axis_names = AXES

    def __init__(self, entries, distributed=False):
        grid = numpy.empty((len(entries), len(entries[0])), dtype=object)
        for (d, row) in enumerate(entries):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows of unequal lengths.")
            for (m, (rank, device)) in enumerate(row):
                grid[d, m] = (int(rank), torch.device(device))
        self.devices = grid
        self.distributed = distributed
        self.rank = _process_rank() if distributed else grid[0, 0][0]
        self._groups = {}
        if distributed:
            self._make_groups()

    @property
    def shape(self):
        return dict(zip(AXES, self.devices.shape))

    def size(self, axis):
        return self.devices.shape[AXES.index(axis)]

    def entry_rank(self, d, m):
        return self.devices[d, m][0]

    def entry_device(self, d, m):
        return self.devices[d, m][1]

    def local_positions(self):
        """Grid positions ``(d, m)`` this process holds, in grid order."""
        (n_data, n_model) = self.devices.shape
        return [(d, m) for d in range(n_data) for m in range(n_model)
                if self.devices[d, m][0] == self.rank]

    def local_indices(self, axis):
        """The sorted indices along ``axis`` of this process's entries."""
        position = AXES.index(axis)
        return sorted({pos[position] for pos in self.local_positions()})

    def local_device(self):
        """The one device of this process's shards (training runs every
        local shard on it); raises if they are on several."""
        devices = {self.devices[pos][1] for pos in self.local_positions()}
        if len(devices) != 1:
            raise ValueError(f"this process's shards are on {sorted(map(str, devices))}; "
                             "the training step needs them on one device.")
        return devices.pop()

    def device_of(self, axis, index):
        """The device of this process's first entry at ``index`` on ``axis``."""
        position = AXES.index(axis)
        for pos in self.local_positions():
            if pos[position] == index:
                return self.devices[pos][1]
        raise ValueError(f"this process holds no entry at {axis}={index}.")

    def ranks(self):
        """Every rank of the mesh, sorted."""
        return sorted({entry[0] for entry in self.devices.flat})

    def _line_ranks(self, axis, index):
        """Ranks along ``axis`` in the line through ``index`` of the other axis."""
        line = self.devices[:, index] if axis == "data" else self.devices[index, :]
        return tuple(sorted({entry[0] for entry in line}))

    def _make_groups(self):
        import torch.distributed as dist

        world = tuple(range(dist.get_world_size()))
        # Every process calls new_group for every line, in the same order.
        made = {}
        for axis in AXES:
            other = 1 - AXES.index(axis)
            for index in range(self.devices.shape[other]):
                ranks = self._line_ranks(axis, index)
                if ranks == world:
                    made[ranks] = dist.group.WORLD
                elif len(ranks) > 1 and ranks not in made:
                    made[ranks] = dist.new_group(list(ranks))
        self._line_groups = made

    def group(self, axis):
        """``(process group or None, number of processes)`` of this
        process's line along ``axis``. None means the line's other shards
        are all in this process: nothing to communicate."""
        if axis in self._groups:
            return self._groups[axis]
        if not self.distributed:
            self._groups[axis] = (None, 1)
            return self._groups[axis]
        other = 1 - AXES.index(axis)
        lines = {self._line_ranks(axis, pos[other]) for pos in self.local_positions()}
        if len(lines) != 1:
            raise ValueError(f"this process's shards lie on {len(lines)} {axis} lines "
                             "with different processes.")
        ranks = lines.pop()
        self._groups[axis] = (self._line_groups.get(ranks), len(ranks))
        return self._groups[axis]


def make_mesh(model_parallelism=1, devices=None):
    """Builds a :class:`Mesh` with axes ``("data", "model")``.

    ``devices`` lists the devices in mesh order (``torch.device`` or
    strings; one device may come several times), or ``(rank, device)``
    pairs. Plain devices belong to this process. By default: inside a
    ``torch.distributed`` world, every process's devices in rank order
    (``parallel.distributed.initialize`` says which); outside one, every
    visible card. Adjacent model-axis entries are consecutive in the
    list.
    """
    distributed = False
    if devices is None:
        from autoencoder_based_image_compression_tpu_torch.parallel import distributed as dist_mod

        if dist_mod.is_initialized():
            entries = dist_mod.world_devices()
            distributed = True
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no card is visible: pass `devices` (for example "
                                   "['cpu'] * 8) to build a mesh on the CPU.")
            entries = [(0, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
    else:
        rank = _process_rank()
        entries = [tuple(entry) if isinstance(entry, (tuple, list)) else (rank, entry)
                   for entry in devices]
        distributed = len({rank for (rank, _) in entries}) > 1
    (n_data, n_model) = mesh_shape_for(len(entries), model_parallelism)
    grid = [entries[d * n_model:(d + 1) * n_model] for d in range(n_data)]
    return Mesh(grid, distributed=distributed)
