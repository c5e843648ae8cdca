"""Several processes as one mesh: process start, global mesh, batch router.

Counterpart of the reference's ``parallel/distributed.py``:

- :func:`initialize` joins this process to a ``torch.distributed`` world
  (NCCL between cards, gloo when the caller asks for the CPU), with the
  devices it will hold;
- :func:`make_global_mesh` lays a ``(data, model)`` mesh over every
  process's devices so that the ``model`` axis never crosses a process:
  the per-map collectives of the density table stay inside one process,
  and only the data-parallel reductions go between processes;
- :func:`global_batch` / :func:`global_state` hand each process its own
  pieces of the batch and of the state, so that each feeds only its
  shard;
- :func:`fetch_replicated` and :func:`agree_across_processes` read the
  result back whole and check that every process holds the same.

The sharded step functions (``parallel/train_parallel.py``) take the
mesh: one process and several differ only in the mesh handed to them.
"""

import datetime

import numpy
import torch
import torch.distributed as dist

from autoencoder_based_image_compression_tpu_torch.parallel.mesh import Mesh
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

# This process's devices, as `initialize` set them.
_LOCAL_DEVICES = []


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address, num_processes, process_id, local_device_ids=None,
               initialization_timeout=60, device="cuda"):
    """Joins the ``torch.distributed`` world of ``num_processes``.

    Call once per process, before any mesh is made.
    ``coordinator_address`` is ``"host:port"`` of process 0.
    ``device="cuda"`` runs NCCL, with this process on the card
    ``local_device_ids[0]`` (default: ``process_id`` modulo the visible
    cards); NCCL takes one rank a card, so two processes cannot share
    one. ``device="cpu"`` runs gloo, and ``local_device_ids`` then only
    counts this process's CPU shards (default one).
    ``initialization_timeout`` (seconds) is the process group's timeout.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        ids = list(local_device_ids) if local_device_ids is not None else [
            process_id % torch.cuda.device_count()]
        local = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(local[0])
        backend = "nccl"
    else:
        local = [torch.device("cpu")] * (len(local_device_ids) if local_device_ids else 1)
        backend = "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout))
    _LOCAL_DEVICES[:] = local


def shutdown():
    """Leaves the world (the counterpart of ``jax.distributed.shutdown``)."""
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICES[:] = []


def world_devices():
    """``(rank, device)`` of every process's devices, in rank order."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in _LOCAL_DEVICES])
    return [(rank, torch.device(device)) for (rank, devices) in enumerate(gathered)
            for device in devices]


def make_global_mesh(model_parallelism=1):
    """Builds a global ``(data, model)`` mesh over every process.

    Devices are grouped by owning process first, so a reshape to
    ``(n_data, model_parallelism)`` keeps each model group inside one
    process (``model_parallelism`` must divide the per-process device
    count). The data axis then spans processes. Every process calls it;
    it makes the axis groups once.
    """
    entries = world_devices()
    per_process = {}
    for (rank, device) in entries:
        per_process.setdefault(rank, []).append(device)
    counts = {len(v) for v in per_process.values()}
    if len(counts) != 1:
        raise ValueError(f"Uneven per-process device counts: {sorted(counts)}.")
    local_count = counts.pop()
    if local_count % model_parallelism != 0:
        raise ValueError(
            f"model_parallelism={model_parallelism} does not divide the "
            f"per-process device count {local_count}; the model axis would "
            "cross a host (DCN) boundary.")
    n_model = model_parallelism
    grid = [entries[i:i + n_model] for i in range(0, len(entries), n_model)]
    return Mesh(grid, distributed=True)


def all_gather_objects(value, mesh):
    """``value`` of every process of ``mesh``, in rank order (this
    process's alone for a one-process mesh)."""
    if not mesh.distributed:
        return [value]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, value)
    return [gathered[rank] for rank in mesh.ranks()]


def global_batch(local_batch, mesh):
    """This process's shard of the global image batch, as a
    :class:`parallel.sharding.ShardedBatch` split over ``data``.

    Each process passes only the examples it loaded, split evenly over
    its data blocks; the global batch has ``local_batch.shape[0] *
    n_data / n_local_blocks`` images. Every process must pass the same
    local shape, which is checked.
    """
    from autoencoder_based_image_compression_tpu_torch.parallel.sharding import ShardedBatch

    local_batch = torch.as_tensor(numpy.asarray(local_batch)
                                  if not torch.is_tensor(local_batch) else local_batch)
    shapes = all_gather_objects(tuple(local_batch.shape), mesh)
    if len(set(shapes)) != 1:
        raise ValueError(f"the processes' local batches differ in shape: {shapes}.")
    blocks = mesh.local_indices("data")
    if local_batch.shape[0] % len(blocks):
        raise ValueError(f"a local batch of {local_batch.shape[0]} does not split over "
                         f"{len(blocks)} data blocks.")
    per_block = local_batch.shape[0] // len(blocks)
    pieces = {(d, None): local_batch[i * per_block:(i + 1) * per_block].to(
        mesh.device_of("data", d)) for (i, d) in enumerate(blocks)}
    global_shape = (per_block * mesh.size("data"),) + tuple(local_batch.shape[1:])
    return ShardedBatch(mesh, pieces, global_shape, spatial=False)


def put_global(host_value, spec, mesh):
    """Places a host value (the same on every process) onto ``mesh``
    under ``spec`` (``"replicated"``, ``"data"`` or ``"model"``); each
    process keeps only its own pieces."""
    from autoencoder_based_image_compression_tpu_torch.parallel import sharding

    return sharding.place(torch.as_tensor(host_value), spec, mesh)


def global_state(state, mesh):
    """Multi-process version of ``train_parallel.shard_state``.

    Every process must hold the same host-side ``state`` (same seed, or
    the same restored checkpoint). Each keeps only its own rows of the
    leaves split over ``model``.
    """
    from autoencoder_based_image_compression_tpu_torch.parallel.sharding import shard_state

    return shard_state(state, mesh)


def fetch_replicated(tree, mesh=None):
    """The whole value of a sharded tree, on the host (CPU tensors).

    A :class:`train.state.TrainState` held under its
    ``state_shardings`` has its leaves split over ``model`` gathered
    back; a ladder sharded by ``train.ladder.shard_ladder_state`` is
    stacked again; a :class:`parallel.sharding.ShardedBatch` is
    assembled; any other leaf is replicated and read locally, with no
    traffic between processes.
    """
    from autoencoder_based_image_compression_tpu_torch.parallel import sharding

    return sharding.fetch(tree, mesh)


def agree_across_processes(value, mesh=None):
    """All-gathers a host scalar or array and checks that every process
    sent the same value (a cheap cross-process consistency check)."""
    value = numpy.asarray(value)
    if mesh is None:
        if not is_initialized():
            return True
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, value)
    else:
        gathered = all_gather_objects(value, mesh)
    return all(numpy.array_equal(other, gathered[0]) for other in gathered)
