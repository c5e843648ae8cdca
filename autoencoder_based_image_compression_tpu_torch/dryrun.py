"""A dry run of the distributed layer on tiny shapes.

Counterpart of the reference's ``__graft_entry__.py::dryrun_multichip``:
on a one-process mesh of ``n_devices`` shards of one device (a card, or
the CPU), it runs one sharded training step, the height-sharded round
trip of 32 x 32 images, a ``PipelinedCompressor`` pass over the mesh,
the height-sharded round trip of a 256 x 384 batch against the unsharded
one (largest gap under 5e-2 of a pixel level) and a sharded ladder step.
Raises on any failure.

    python -m autoencoder_based_image_compression_tpu_torch.dryrun [n_devices] [--device cpu]
"""

import argparse

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

SPATIAL_GAP = 5.0e-2


def dryrun_multichip(n_devices, device="cuda"):
    """Runs the five steps on ``n_devices`` shards of ``device``; returns
    ``{"spatial_gap": largest pixel gap at 256 x 384 or None}``."""
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
        roundtrip_batched,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
    from autoencoder_based_image_compression_tpu_torch.parallel.train_parallel import (
        make_sharded_step_fns,
        shard_state,
    )
    from autoencoder_based_image_compression_tpu_torch.train.ladder import (
        init_ladder_state,
        make_ladder_step_fns,
        shard_ladder_state,
    )
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

    device = resolve_device(device)
    model_parallelism = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(model_parallelism, devices=[device] * n_devices)
    n_data = n_devices // model_parallelism

    gamma = 10000.0
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=16,
                             device=device)
    state = shard_state(state, mesh)
    fns = make_sharded_step_fns(gamma, True, mesh, state, max_itvs=16)
    batch = torch.from_numpy(numpy.random.default_rng(1).integers(
        0, 256, size=(2 * n_data, 32, 32, 1)).astype(numpy.float32))
    state = fns["train_step"](state, batch, torch.Generator(device).manual_seed(2))
    if int(state.step) != 1:
        raise AssertionError(f"the sharded step left step {int(state.step)}")

    # Sharded inference: the height over `model`, halos exchanged.
    images = numpy.random.default_rng(3).integers(
        16, 236, size=(2 * n_data, 32, 32, 1)).astype(numpy.uint8)
    bin_widths = state.bin_widths.cpu().numpy()
    recs = roundtrip_batched(state.params, images, bin_widths, True, batch_size=2 * n_data,
                             mesh=mesh, spatial=model_parallelism > 1)
    if recs.shape != images.shape:
        raise AssertionError(f"spatial round trip: {recs.shape}")

    # Serving: device encode and decode over the data axis, host coder.
    nb_maps = bin_widths.shape[0]
    compressor = PipelinedCompressor(
        state.params, bin_widths, True, binary_probabilities=numpy.full((nb_maps, 10), 0.5),
        map_mean=numpy.zeros(nb_maps, numpy.float32), mesh=mesh, batch_size=2 * n_data)
    (recs_served, nb_bits) = compressor(images)
    if recs_served.shape != images.shape or nb_bits.shape != (images.shape[0],) \
            or int(nb_bits.min()) <= 0:
        raise AssertionError(f"pipeline over the mesh: {recs_served.shape}, bits {nb_bits}")

    # Kodak-shaped geometry against the unsharded result (the 32 x 32
    # shapes leave the 9x9 stride-4 convs' halos degenerate).
    gap = None
    if model_parallelism > 1:
        kodak_shaped = numpy.random.default_rng(5).integers(
            16, 236, size=(n_data, 256, 384, 1)).astype(numpy.uint8)
        sharded = roundtrip_batched(state.params, kodak_shaped, bin_widths, True,
                                    batch_size=n_data, mesh=mesh, spatial=True)
        plain = roundtrip_batched(state.params, kodak_shaped, bin_widths, True,
                                  batch_size=n_data, device=device)
        gap = float(numpy.abs(sharded - plain).max())
        if not gap < SPATIAL_GAP:
            raise AssertionError(f"the height-sharded 256 x 384 round trip deviates from the "
                                 f"unsharded one by {gap} (halo exchange fault?)")

    # The gamma ladder with its models spread over the shards.
    nb_ladder = min(4, n_devices)
    gammas = [10000.0, 16000.0, 40000.0, 96000.0][:nb_ladder]
    ladder = init_ladder_state(torch.Generator().manual_seed(7), gammas, device=device)
    ladder = shard_ladder_state(ladder, make_mesh(1, devices=[device] * nb_ladder))
    ladder = make_ladder_step_fns(gammas)["train_step"](
        ladder, torch.from_numpy(images[:2].astype(numpy.float32)),
        torch.Generator(device).manual_seed(8))
    steps = [int(block.step[0]) for block in ladder.blocks.values()]
    if steps != [1] * nb_ladder:
        raise AssertionError(f"ladder steps {steps}")
    return {"spatial_gap": gap}


def main(args=None):
    parser = argparse.ArgumentParser(description="Dry run of the distributed layer.")
    parser.add_argument("n_devices", type=int, nargs="?", default=2)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    args = parser.parse_args(args)
    print(dryrun_multichip(args.n_devices, args.device))


if __name__ == "__main__":
    main()
