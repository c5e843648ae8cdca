"""PyTorch port: the coder binding, the .aeic container and the codec
CLI against the JAX package's."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import pickle
import subprocess

import numpy
import pytest

from autoencoder_based_image_compression_tpu.cli import codec as jax_codec
from autoencoder_based_image_compression_tpu.coding import bitstream_io as jax_bitstream_io
from autoencoder_based_image_compression_tpu.coding import compression as jax_compression
from autoencoder_based_image_compression_tpu.ops import metrics as jax_metrics
from autoencoder_based_image_compression_tpu.utils.image import read_image_mode
from autoencoder_based_image_compression_tpu_torch.cli import codec
from autoencoder_based_image_compression_tpu_torch.coding import bitstream_io, compression, native
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.ops import metrics
from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000", "statistics")
MODEL = os.path.join(os.path.dirname(STATS), "params_trained.npz")


def _statistics():
    probabilities = numpy.load(os.path.join(STATS, "binary_probabilities_1.npy"))
    map_mean = numpy.load(os.path.join(STATS, "map_mean.npy"))
    with open(os.path.join(STATS, "idx_map_exception.pkl"), "rb") as file:
        idx_exc = pickle.load(file)
    return (probabilities, map_mean, idx_exc)


def _symbols(shape, seed):
    rng = numpy.random.default_rng(seed)
    return numpy.clip(numpy.round(rng.laplace(0.0, 1.5, size=shape)),
                      -40, 40).astype(numpy.int16)


def test_coder_selftest(tmp_path):
    out = subprocess.run(["make", "-C", native.CPP_DIR, f"BUILD={tmp_path}", "test"],
                         capture_output=True, text=True, check=True).stdout
    assert "all coder self-tests passed" in out


@pytest.mark.parametrize("verify", [True, False])
def test_compress_lossless_images_matches_jax(verify):
    (probabilities, _, idx_exc) = _statistics()
    symbols = _symbols((3, 4, 6, 128), 1)
    expected = jax_compression.compress_lossless_images(
        symbols, probabilities, idx_exc, verify=verify)
    got = compression.compress_lossless_images(symbols, probabilities, idx_exc,
                                               verify=verify)
    numpy.testing.assert_array_equal(got, expected)
    # A non-contiguous view of the same symbols codes the same.
    view = numpy.moveaxis(numpy.moveaxis(symbols, 3, 0).copy(), 0, 3)
    assert not view.flags["C_CONTIGUOUS"]
    numpy.testing.assert_array_equal(
        compression.compress_lossless_images(view, probabilities, idx_exc), expected)


def test_compress_lossless_maps_matches_jax():
    (probabilities, _, idx_exc) = _statistics()
    symbols = _symbols((4, 6, 128), 2)
    (rec_jax, bits_jax) = jax_compression.compress_lossless_maps(
        symbols, probabilities, idx_exc)
    (rec, bits) = compression.compress_lossless_maps(symbols, probabilities, idx_exc)
    numpy.testing.assert_array_equal(rec, rec_jax)
    numpy.testing.assert_array_equal(rec, symbols)
    numpy.testing.assert_array_equal(bits, bits_jax)


def test_metrics_match_jax():
    rng = numpy.random.default_rng(3)
    samples = 0.5 * numpy.round(rng.normal(size=500) / 0.5)
    assert metrics.discrete_entropy(samples, 0.5) == jax_metrics.discrete_entropy(samples, 0.5)
    numpy.testing.assert_array_equal(metrics.count_symbols(samples, 0.5),
                                     jax_metrics.count_symbols(samples, 0.5))
    (a, b) = rng.integers(0, 256, size=(2, 16, 24)).astype(numpy.uint8)
    assert metrics.psnr_2d(a, b) == jax_metrics.psnr_2d(a, b)


def test_aeic_files_byte_identical(tmp_path):
    (probabilities, map_mean, idx_exc) = _statistics()
    bin_widths = numpy.linspace(0.5, 2.0, 128).astype(numpy.float32)
    centered_quantized = _symbols((4, 6, 128), 4).astype(numpy.float32) * bin_widths
    path_jax = str(tmp_path / "jax.aeic")
    path = str(tmp_path / "port.aeic")
    bits_jax = jax_bitstream_io.write_compressed_latents(
        path_jax, centered_quantized, bin_widths, map_mean, probabilities, idx_exc)
    bits = bitstream_io.write_compressed_latents(
        path, centered_quantized, bin_widths, map_mean, probabilities, idx_exc)
    assert bits == bits_jax
    with open(path, "rb") as f_port, open(path_jax, "rb") as f_jax:
        assert f_port.read() == f_jax.read()
    (decoded, bw_read, mean_read) = bitstream_io.read_compressed_latents(path_jax, probabilities)
    numpy.testing.assert_array_equal(decoded, centered_quantized)
    numpy.testing.assert_array_equal(bw_read, bin_widths)
    numpy.testing.assert_array_equal(mean_read, map_mean.astype(numpy.float32))
    with pytest.raises(AssertionError):  # int16 overflow guard
        bitstream_io.write_compressed_latents(
            str(tmp_path / "bad.aeic"), centered_quantized * 1e4, bin_widths,
            map_mean, probabilities, idx_exc)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_cross_decoding(tmp_path, writer, capsys):
    luminance = synthetic_luminance_stack(1, 64, 96, seed=5)[0, :, :, 0]
    path_in = str(tmp_path / "input.png")
    path_bin = str(tmp_path / "image.aeic")
    save_image(path_in, luminance)
    port = lambda argv: codec.main(argv + ["--device", "cpu"])  # noqa: E731
    (write, other) = (jax_codec.main, port) if writer == "jax" else (port, jax_codec.main)
    write(["compress", path_in, path_bin, "--model", MODEL])
    printed = capsys.readouterr().out
    assert f"{path_in} (64x96) -> {path_bin}: " in printed and "bpp" in printed
    psnrs = {}
    for (name, decoder) in (("same", write), ("other", other)):
        path_out = str(tmp_path / f"{name}.png")
        decoder(["decompress", path_bin, path_out, "--model", MODEL])
        psnrs[name] = jax_metrics.psnr_2d(luminance, read_image_mode(path_out, "L"))
    # The gate of the port: the two decoders agree within 0.05 dB.
    assert abs(psnrs["same"] - psnrs["other"]) <= 0.05
    assert psnrs["other"] > 20.0
    # A file written by either CLI decodes to the same symbols in both.
    (probabilities, _, _) = _statistics()
    numpy.testing.assert_array_equal(
        bitstream_io.read_compressed_latents(path_bin, probabilities)[0],
        jax_bitstream_io.read_compressed_latents(path_bin, probabilities)[0])


def test_cli_refuses_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    path_in = str(tmp_path / "input.png")
    save_image(path_in, synthetic_luminance_stack(1, 32, 32, seed=1)[0, :, :, 0])
    with pytest.raises(RuntimeError, match="cuda"):
        codec.main(["compress", path_in, str(tmp_path / "x.aeic"), "--model", MODEL])
