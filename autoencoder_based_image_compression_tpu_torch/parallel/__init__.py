"""Parallel and distributed layer: meshes, shardings, the sharded
training step and sharded inference.

Counterpart of the reference's ``parallel/``: weights replicated, image
batches split over the ``data`` axis, the density table and the bin
widths split per map over the ``model`` axis, and in inference the image
height split over ``model`` too, with the halo rows the strided convs
need exchanged by ``parallel.spatial``. A mesh's shards are held by one
process in turn or by several processes over ``torch.distributed``.
"""

from autoencoder_based_image_compression_tpu_torch.parallel.distributed import (
    agree_across_processes,
    fetch_replicated,
    global_batch,
    global_state,
    make_global_mesh,
)
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_shape_for,
)
from autoencoder_based_image_compression_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicated,
    state_shardings,
)
