"""PyTorch port: PipelinedCompressor and roundtrip_batched against the
JAX package's, on the trained models and their coding statistics."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import pickle

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu.parallel import inference as jax_inference
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    PipelinedCompressor,
    roundtrip_batched,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")


def _experiment(exp_dir):
    path = os.path.join(exp_dir, "params_trained.npz")
    (params_jax, bin_widths) = jax_load_params_artifact(path)
    (params_np, _) = load_params_artifact(path)
    stats_dir = os.path.join(exp_dir, "statistics")
    map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
    probabilities = numpy.load(os.path.join(stats_dir, "binary_probabilities_1.npy"))
    with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
        idx_exc = pickle.load(file)
    return (params_jax, params_from_jax(params_np), numpy.asarray(bin_widths),
            map_mean, probabilities, idx_exc)


def _images():
    return synthetic_luminance_stack(4, 64, 96, seed=7)


@pytest.mark.parametrize("fast_path", [None, "bf16w+"])
def test_pipelined_compressor_matches_jax(fast_path):
    (params_jax, params, bw, mean, probs, idx_exc) = _experiment(LEARNED)
    images = _images()
    kwargs = dict(idx_map_exception=idx_exc, batch_size=2, fast_path=fast_path)
    jax_compressor = jax_inference.PipelinedCompressor(
        params_jax, bw, True, probs, mean, **kwargs)
    (recs_jax, bits_jax) = jax_compressor(images)
    compressor = PipelinedCompressor(params, bw, True, probs, mean,
                                     max_in_flight=2, device="cpu", **kwargs)
    (recs, bits) = compressor(images)
    assert recs.shape == recs_jax.shape and recs.dtype == numpy.uint8
    assert bits.shape == (4,) and bits.dtype == numpy.int64
    assert compressor.peak_in_flight <= compressor.max_in_flight
    assert set(compressor.last_timing) == {"wall", "coder", "fetch_wait"}

    # Per image: identical bits wherever the symbols are identical,
    # else within 1 % (a symbol flip changes a few bits of ~10^4).
    (sym_jax, _, _) = jax_compressor.encode_symbols_fn(
        jax_compressor.params, jnp.asarray(images), jax_compressor.bin_widths,
        jax_compressor.map_mean)
    (sym, _, _) = compressor.encode_symbols(torch.from_numpy(images))
    sym_jax = numpy.asarray(sym_jax)
    for i in range(images.shape[0]):
        if numpy.array_equal(sym[i].numpy(), sym_jax[i]):
            assert bits[i] == bits_jax[i]
        else:
            assert abs(int(bits[i]) - int(bits_jax[i])) <= 0.01 * int(bits_jax[i])
        # Same symbols into the same decoder: fp32 is a pure
        # summation-order gap, bf16w+ adds bf16 rounding-site ulps.
        if not numpy.array_equal(recs[i], recs_jax[i]):
            assert psnr_2d(recs_jax[i, :, :, 0], recs[i, :, :, 0]) >= 50.0


def test_pipelined_compressor_compress_only_and_window():
    (_, params, bw, mean, probs, idx_exc) = _experiment(LEARNED)
    images = synthetic_luminance_stack(6, 32, 48, seed=8)
    full = PipelinedCompressor(params, bw, True, probs, mean, idx_map_exception=idx_exc,
                               batch_size=1, max_in_flight=2, device="cpu")
    (recs, bits) = full(images)
    assert full.peak_in_flight == 2
    only = PipelinedCompressor(params, bw, True, probs, mean, idx_map_exception=idx_exc,
                               batch_size=1, max_in_flight=64, reconstruct=False,
                               verify=False, device="cpu")
    (none, bits_only) = only(images)
    assert none is None
    assert only.peak_in_flight == 6  # the window never binds
    numpy.testing.assert_array_equal(bits_only, bits)
    assert recs.shape == images.shape


def test_pipelined_compressor_overflow_guard_raises():
    (_, params, bw, mean, probs, idx_exc) = _experiment(LEARNED)
    # Tiny bin widths push |symbol| far beyond int16: the guard must
    # raise before anything wrapped is coded.
    compressor = PipelinedCompressor(params, bw * 1e-6, True, probs, mean,
                                     idx_map_exception=idx_exc, batch_size=2,
                                     device="cpu")
    with pytest.raises(OverflowError):
        compressor(synthetic_luminance_stack(2, 32, 48, seed=9))


def test_pipelined_compressor_rejects_bad_arguments():
    (_, params, bw, mean, probs, _) = _experiment(LEARNED)
    for kwargs in (dict(fast_path="bf16"), dict(fast_path="fp8"),
                   dict(max_in_flight=0)):
        with pytest.raises(ValueError):
            PipelinedCompressor(params, bw, True, probs, mean, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        PipelinedCompressor(params, bw, False, probs, mean, fast_path="bf16w+",
                            device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    (_, params, bw, mean, probs, _) = _experiment(LEARNED)
    with pytest.raises(RuntimeError, match="cuda"):
        PipelinedCompressor(params, bw, True, probs, mean)
    with pytest.raises(RuntimeError, match="cuda"):
        roundtrip_batched(params, _images(), bw, True, 2)


@pytest.mark.parametrize("exp_dir,learn_bin_widths", [(FIXED, False), (LEARNED, True)])
def test_roundtrip_batched_matches_jax(exp_dir, learn_bin_widths):
    (params_jax, params, bw, _, _, _) = _experiment(exp_dir)
    images = _images()
    expected = jax_inference.roundtrip_batched(params_jax, images, bw,
                                               learn_bin_widths, batch_size=2)
    got = roundtrip_batched(params, images, bw, learn_bin_widths, batch_size=2,
                            device="cpu")
    assert got.shape == expected.shape == images.shape and got.dtype == numpy.float32
    # Reconstruction against reconstruction; the fixed-bw port runs
    # GDN_3 + quantiser as the fused gdn_quantize's plain version here.
    mse = numpy.mean((got.astype(numpy.float64) - expected) ** 2)
    assert mse == 0.0 or 10.0 * numpy.log10(255.0 ** 2 / mse) >= 60.0
