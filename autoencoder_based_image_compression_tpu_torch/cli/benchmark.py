"""Throughput / parity / profiling benchmark CLI.

Counterpart of the reference's ``cli/benchmark.py``:

- ``parity``: the fp32 parity path against the bf16 fast path (Mpix/s
  each and the PSNR between their reconstructions), one JSON line;
- ``profile``: writes a ``torch.profiler`` Chrome trace of one round
  trip for per-kernel inspection;
- ``scaling``: the round trip's Mpix/s over data-parallel meshes of
  1, 2, 4 ... cards, one JSON line with the card's name and power limit
  (on one card, the one-device row alone: not a scaling figure).

Runs on ``--device cuda`` (default; fails without a card) or ``cpu``.
"""

import argparse
import json
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.eval.serving_bench import device_line
from autoencoder_based_image_compression_tpu_torch.eval.throughput import (
    parity_and_throughput,
    profile_roundtrip,
    scaling_report,
)
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device


def main(args=None):
    parser = argparse.ArgumentParser(description="Benchmarks.")
    parser.add_argument("command", choices=["parity", "scaling", "profile"])
    parser.add_argument("--nb_images", type=int, default=24)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--per_device_batch", type=int, default=4)
    parser.add_argument("--model_parallelism", type=int, default=1)
    parser.add_argument("--trace_dir", default=os.path.join("build", "aeic_trace"),
                        help="where `profile` writes its trace (relative to the "
                             "working directory)")
    parser.add_argument("--checkpoint", default="",
                        help="optional trained checkpoint (npz prefix)")
    parser.add_argument("--gamma", type=float, default=10000.0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    args = parser.parse_args(args)

    device = resolve_device(args.device)
    if args.checkpoint:
        from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
            load_checkpoint,
        )
        from autoencoder_based_image_compression_tpu_torch.train.state import (
            init_train_state,
        )

        template = init_train_state(torch.Generator().manual_seed(0), 1.0, True,
                                    device=device)
        state = load_checkpoint(args.checkpoint, template)
        (params, bin_widths) = (state.params, state.bin_widths.cpu().numpy())
    else:
        params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(0), True)
        bin_widths = numpy.ones(128, numpy.float32)

    rng = numpy.random.default_rng(0)
    images = rng.integers(16, 236, size=(args.nb_images, args.height, args.width, 1)
                          ).astype(numpy.uint8)

    if args.command == "parity":
        print(json.dumps(parity_and_throughput(params, images, bin_widths, device=device)))
    elif args.command == "scaling":
        report = scaling_report(params, bin_widths, (args.height, args.width),
                                args.per_device_batch, args.model_parallelism, device=device)
        report["device"] = device_line(device)
        print(json.dumps(report))
    else:
        trace = profile_roundtrip(params, images[:4], bin_widths, args.trace_dir,
                                  device=device)
        print(f"trace written to {trace}")


if __name__ == "__main__":
    main()
