"""Image <-> bitstream codec CLI on the PyTorch port.

``compress`` turns a luminance image into an ``.aeic`` bitstream
(device encode + quantise, host C++ arithmetic coder); ``decompress``
turns the bitstream back into a PNG (host coder, device decode). The
files are byte-compatible with the reference package's CLI. The coding
model is a trained params artifact plus the extra-set statistics of its
experiment directory.

Usage:
    python -m autoencoder_based_image_compression_tpu_torch.cli.codec \
        compress input.png out.aeic [--model .../params_trained.npz] \
        [--multiplier 1.0] [--device cuda]
    python -m autoencoder_based_image_compression_tpu_torch.cli.codec \
        decompress in.aeic out.png [--model ...] [--multiplier 1.0] \
        [--reference input.png] [--device cuda]

The truncated-unary probability tables are shared by encoder and
decoder (not stored in the bitstream), so ``decompress`` must name the
same --model/--multiplier. ``--device`` defaults to ``cuda`` and raises
without a card; pass ``--device cpu`` to run on the CPU.
"""

import argparse
import os
import pickle

import numpy
import torch

DEFAULT_MODEL = os.path.join("results", "eae", "learning_bw", "0dot5_10000",
                             "params_trained.npz")


def _load_model(path_model):
    """(params, bin_widths, learn_bin_widths) from a params artifact.

    The fixed-bin-width variant carries the extra GDN_3/IGDN_4 pair.
    """
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
        load_params_artifact,
        params_from_jax,
    )

    (params_np, bin_widths) = load_params_artifact(path_model)
    return (params_from_jax(params_np), bin_widths, "gamma_3" not in params_np)


def _load_statistics(path_model, multiplier):
    """(map_mean, probabilities, idx_map_exception) for the model's
    experiment directory at the requested bin-width multiplier."""
    from autoencoder_based_image_compression_tpu_torch.utils.naming import float_to_str

    stats_dir = os.path.join(os.path.dirname(path_model), "statistics")
    path_probs = os.path.join(
        stats_dir, f"binary_probabilities_{float_to_str(multiplier)}.npy")
    if not os.path.isfile(path_probs):
        raise FileNotFoundError(
            f"{path_probs} not found: collect the extra-set statistics for "
            "this model with a multiplier ladder that includes "
            f"{multiplier}.")
    map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
    with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
        idx_map_exception = pickle.load(file)
    return (map_mean, numpy.load(path_probs), idx_map_exception)


def _read_luminance(path):
    """Reads an image as (H, W) uint8 luminance (BT.601 for RGB input)."""
    from PIL import Image

    from autoencoder_based_image_compression_tpu_torch.utils.image import (
        luminance_bt601,
    )

    image = Image.open(path)
    if image.mode == "L":
        return numpy.asarray(image, numpy.uint8)
    if image.mode in ("RGB", "RGBA"):
        rgb = numpy.asarray(image.convert("RGB"), numpy.uint8)
        return luminance_bt601(rgb)
    raise ValueError(f"unsupported image mode {image.mode} (need L or RGB).")


def _on_device(params, device):
    return {name: value.to(device) for (name, value) in params.items()}


def compress(args):
    from autoencoder_based_image_compression_tpu_torch.coding.bitstream_io import (
        write_compressed_latents,
    )
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
        quantize_per_map,
    )
    from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    (params, bin_widths, learn_bin_widths) = _load_model(args.model)
    (map_mean, probabilities, idx_exc) = _load_statistics(args.model,
                                                          args.multiplier)
    luminance = _read_luminance(args.input)
    (height, width) = luminance.shape
    if height % 16 or width % 16:
        # H and W must be divisible by the stride product.
        raise ValueError(f"image is {height}x{width}; both sides must be "
                         "multiples of 16.")
    bin_widths_test = numpy.asarray(bin_widths, numpy.float32) * args.multiplier

    visible = torch.from_numpy(luminance[None, :, :, None].astype(numpy.float32))
    y = conv_eae.encode(_on_device(params, device), visible.to(device),
                        learn_bin_widths)[0]
    mean = torch.from_numpy(map_mean.astype(numpy.float32)).to(device)
    centered_quantized = quantize_per_map(
        y - mean, torch.from_numpy(bin_widths_test).to(device)).cpu().numpy()
    nb_bits = write_compressed_latents(
        args.output, centered_quantized, bin_widths_test, map_mean,
        probabilities, idx_exc)
    print(f"{args.input} ({height}x{width}) -> {args.output}: "
          f"{nb_bits} bits = {nb_bits / (height * width):.4f} bpp")


def decompress(args):
    from autoencoder_based_image_compression_tpu_torch.coding.bitstream_io import (
        read_compressed_latents,
    )
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
    from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    device = resolve_device(args.device)
    (params, _, learn_bin_widths) = _load_model(args.model)
    (_, probabilities, _) = _load_statistics(args.model, args.multiplier)
    (centered_quantized, _, map_mean) = read_compressed_latents(
        args.input, probabilities)
    quantized = torch.from_numpy(centered_quantized + map_mean.reshape(1, 1, -1))
    decoded = conv_eae.decode(_on_device(params, device),
                              quantized[None].to(device), learn_bin_widths)
    reconstruction = cast_bt601(decoded[0, :, :, 0].cpu().numpy())
    save_image(args.output, reconstruction)
    print(f"{args.input} -> {args.output} ({reconstruction.shape[0]}x"
          f"{reconstruction.shape[1]})")
    if args.reference:
        from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d

        psnr = psnr_2d(_read_luminance(args.reference), reconstruction)
        print(f"PSNR vs {args.reference}: {psnr:.2f} dB")


def main(args=None):
    parser = argparse.ArgumentParser(
        description="AEIC image codec (compress/decompress), PyTorch port.")
    sub = parser.add_subparsers(dest="command", required=True)
    for (name, fn) in [("compress", compress), ("decompress", decompress)]:
        p = sub.add_parser(name)
        p.add_argument("input")
        p.add_argument("output")
        p.add_argument("--model", default=DEFAULT_MODEL,
                       help="params artifact (params_trained.npz); the "
                            "statistics directory must sit beside it")
        p.add_argument("--multiplier", type=float, default=1.0,
                       help="bin-width multiplier (rate control; must be in "
                            "the collected statistics ladder)")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default; raises without a card) or 'cpu'")
        p.set_defaults(fn=fn)
    sub.choices["decompress"].add_argument(
        "--reference", default="",
        help="original image; prints the reconstruction PSNR")
    parsed = parser.parse_args(args)
    parsed.fn(parsed)


if __name__ == "__main__":
    main()
