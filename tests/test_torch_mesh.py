"""PyTorch port: meshes and the process-level layer (``parallel/mesh.py``,
``parallel/distributed.py``, ``parallel/sharding.py``) against the JAX
package's: the same shapes and the same errors, and the specs of each
state leaf. The world of processes here is one gloo process (the
two-process runs are ``tests/test_torch_distributed.py``)."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import socket

import jax
import numpy
import pytest
import torch
import torch.distributed as dist

from autoencoder_based_image_compression_tpu.parallel import distributed as jax_distributed
from autoencoder_based_image_compression_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from autoencoder_based_image_compression_tpu.parallel.mesh import (
    mesh_shape_for as jax_mesh_shape_for,
)
from autoencoder_based_image_compression_tpu_torch.parallel import distributed, sharding
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape_for,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture
def world_of_one():
    """A gloo world of this one process holding 8 CPU shards; left on exit."""
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, local_device_ids=list(range(8)),
                           initialization_timeout=60, device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("nb_devices,model", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 3), (1, 1)])
def test_mesh_shape_for_matches_jax(nb_devices, model):
    assert mesh_shape_for(nb_devices, model) == jax_mesh_shape_for(nb_devices, model)


@pytest.mark.parametrize("nb_devices,model", [(8, 3), (6, 4), (1, 2)])
def test_mesh_shape_for_raises_as_jax_does(nb_devices, model):
    with pytest.raises(ValueError) as jax_error:
        jax_mesh_shape_for(nb_devices, model)
    with pytest.raises(ValueError) as error:
        mesh_shape_for(nb_devices, model)
    assert str(error.value) == str(jax_error.value)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_make_mesh_on_repeated_devices(model):
    mesh = make_mesh(model, devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (8 // model, model) == tuple(mesh.shape.values())
    assert all(entry == (0, torch.device("cpu")) for entry in mesh.devices.flat)
    assert not mesh.distributed
    # One process holds every shard, and no line needs a collective.
    assert len(mesh.local_positions()) == 8
    assert mesh.local_indices("data") == list(range(8 // model))
    assert mesh.group("data") == (None, 1) and mesh.group("model") == (None, 1)
    assert mesh.local_device() == torch.device("cpu")


def test_make_mesh_matches_jax_layout():
    mesh = make_mesh(2, devices=["cpu"] * 8)
    jax_mesh = jax_make_mesh(model_parallelism=2)
    assert mesh.axis_names == tuple(jax_mesh.axis_names)
    assert mesh.devices.shape == jax_mesh.devices.shape


def test_make_mesh_needs_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices"):
        make_mesh(1)
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(3, devices=["cpu"] * 4)


def test_make_mesh_of_ranks_is_distributed_only_across_processes():
    mesh = make_mesh(1, devices=[(0, "cpu"), (0, "cpu")])
    assert not mesh.distributed and mesh.rank == 0


def test_state_shardings_split_the_table_and_bin_widths_over_model():
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=16,
                             device="cpu")
    specs = sharding.state_shardings(make_mesh(2, devices=["cpu"] * 8), state)
    assert specs.density.parameters == "model" and specs.bin_widths == "model"
    assert specs.density.nb_itvs_per_side == "replicated" and specs.step == "replicated"
    assert set(specs.params.values()) == {"replicated"}
    assert set(specs.opt_eae.mu.values()) == {"replicated"}
    assert (sharding.batch_sharding(), sharding.replicated()) == ("data", "replicated")


def test_one_process_mesh_holds_every_row_and_fetches_them_back():
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=16,
                             device="cpu")
    mesh = make_mesh(2, devices=["cpu"] * 8)
    sharded = sharding.shard_state(state, mesh)
    assert sharded.density.parameters.shape == state.density.parameters.shape
    back = distributed.fetch_replicated(sharded, mesh)
    assert torch.equal(back.density.parameters, state.density.parameters)
    assert torch.equal(back.params["weights_1"], state.params["weights_1"])


def test_split_batch_refuses_an_uneven_split():
    mesh = make_mesh(1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="split evenly"):
        sharding.split_batch(numpy.zeros((6, 32, 32, 1), numpy.float32), mesh)
    with pytest.raises(ValueError, match="multiples of 16"):
        sharding.split_batch(numpy.zeros((4, 48, 32, 1), numpy.float32),
                             make_mesh(2, devices=["cpu"] * 4), spatial=True)
    batch = sharding.split_batch(numpy.arange(8.0).reshape(8, 1, 1, 1), mesh)
    assert [float(p.sum()) for p in batch.pieces.values()] == [1.0, 5.0, 9.0, 13.0]
    assert torch.equal(batch.gather(), torch.arange(8.0).reshape(8, 1, 1, 1))


def test_global_mesh_in_a_world_of_one(world_of_one):
    mesh = distributed.make_global_mesh(2)
    assert mesh.distributed and mesh.devices.shape == (4, 2)
    assert dist.get_backend() == "gloo"
    # The lines span the whole world of one: the world's group, so that the
    # collectives still run.
    assert mesh.group("data") == (dist.group.WORLD, 1)
    assert distributed.agree_across_processes(numpy.float64(3.5), mesh)
    local = numpy.arange(16.0, dtype=numpy.float32).reshape(4, 2, 2, 1)
    batch = distributed.global_batch(local, mesh)
    assert batch.global_shape == (4, 2, 2, 1) and len(batch.pieces) == 4
    assert torch.equal(distributed.fetch_replicated(batch), torch.from_numpy(local))
    assert distributed.put_global(torch.ones(128), "model", mesh).shape == (128,)


@pytest.mark.parametrize("model", [3, 16])
def test_global_mesh_raises_as_jax_does(world_of_one, model):
    """model_parallelism that does not divide the per-process device count
    (8 here, and 8 on the JAX package's CPU platform) gives JAX's error."""
    with pytest.raises(ValueError) as error:
        distributed.make_global_mesh(model)
    if len(jax.devices()) == 8:
        with pytest.raises(ValueError) as jax_error:
            jax_distributed.make_global_mesh(model)
        assert str(error.value) == str(jax_error.value)
    assert "cross a host" in str(error.value)


def test_global_mesh_refuses_uneven_processes(monkeypatch):
    monkeypatch.setattr(distributed, "world_devices",
                        lambda: [(0, torch.device("cpu")), (1, torch.device("cpu")),
                                 (1, torch.device("cpu"))])
    with pytest.raises(ValueError, match=r"Uneven per-process device counts: \[1, 2\]\."):
        distributed.make_global_mesh(1)
