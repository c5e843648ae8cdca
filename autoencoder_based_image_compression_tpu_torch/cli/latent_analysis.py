"""Latent-analysis command line: Laplace fits, activation probe, map masking.

Counterpart of ``kodak_tensorflow/fitting_eae_kodak.py`` (subcommand
``fit``), ``activating_eae.py`` (``activate``: the translation-covariance
probe, one latent activated at two positions and decoded at 256 x 256)
and ``masking_eae_kodak.py`` (``mask``: decode with all maps but one
frozen at their means), and of the reference package's
``cli/latent_analysis.py``, plus ``--device cuda|cpu``. The encoding and
decoding run on the device (through the GDN kernels on the card); the
images are written on the host with PIL.
"""

import argparse
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.eval import analysis
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import load_checkpoint
from autoencoder_based_image_compression_tpu_torch.train.loop import encode_mini_batches
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.image import save_image
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
)

# The activation probe: a 16 x 16 latent, activated at two positions.
PROBE_MAP = 16
PROBE_POSITIONS = (("pos0", (2, 2)), ("pos1", (8, 8)))


def _luminances(path, nb_images=None):
    images = numpy.load(path)[:nb_images]
    return images.reshape(images.shape[0], images.shape[1], images.shape[2], 1)


def activation_probes(params, learn_bin_widths, idx_map, activation_value):
    """``{tag: uint8 reconstruction}`` of the probe at each position,
    with every other latent at 0."""
    map_mean = numpy.zeros(csts.NB_MAPS_3, dtype=numpy.float32)
    return {tag: analysis.activate_latent_variable(
        params, learn_bin_widths, PROBE_MAP, PROBE_MAP, row, col, idx_map, activation_value,
        map_mean) for (tag, (row, col)) in PROBE_POSITIONS}


def main(args=None):
    parser = argparse.ArgumentParser(description="Latent analysis.")
    parser.add_argument("command", choices=["fit", "activate", "mask"])
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("gamma", type=float_strictly_positive)
    parser.add_argument("idx_training", type=int_positive)
    parser.add_argument("--learn_bin_widths", action="store_true")
    parser.add_argument("--idx_map", type=int_positive, default=0)
    parser.add_argument("--activation_value", type=float, default=8.0)
    parser.add_argument("--path_to_kodak", default="data/kodak/kodak.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--out_dir", default="results/analysis")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)

    exp_dir = os.path.join(args.results_root,
                           experiment_suffix(args.bin_width_init, args.gamma,
                                             args.learn_bin_widths))
    template = init_train_state(torch.Generator().manual_seed(0), args.bin_width_init,
                                args.learn_bin_widths, device=args.device)
    state = load_checkpoint(os.path.join(exp_dir, f"model_{args.idx_training}"), template)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.command == "fit":
        y = encode_mini_batches(_luminances(args.path_to_kodak), state.params,
                                args.learn_bin_widths, 4)
        (locations, scales) = analysis.fit_maps(y)
        numpy.save(os.path.join(args.out_dir, "laplace_locations.npy"), locations)
        numpy.save(os.path.join(args.out_dir, "laplace_scales.npy"), scales)
        print(f"Laplace fits: location mean {locations.mean():.4f}, "
              f"scale mean {scales.mean():.4f}")
    elif args.command == "activate":
        for (tag, reconstruction) in activation_probes(
                state.params, args.learn_bin_widths, args.idx_map,
                args.activation_value).items():
            save_image(os.path.join(args.out_dir, f"activation_map{args.idx_map}_{tag}.png"),
                       reconstruction)
        print("activation probes written")
    else:  # mask
        y = encode_mini_batches(_luminances(args.path_to_kodak, 4), state.params,
                                args.learn_bin_widths, 4)
        map_mean = numpy.mean(y, axis=(0, 1, 2))
        masked = analysis.mask_maps(y, state.params, args.learn_bin_widths, args.idx_map,
                                    map_mean)
        for i in range(masked.shape[0]):
            save_image(os.path.join(args.out_dir, f"masked_map{args.idx_map}_image{i}.png"),
                       masked[i])
        print("masked reconstructions written")


if __name__ == "__main__":
    main()
