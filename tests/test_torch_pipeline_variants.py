"""PyTorch port: the "bf16w" and "int8" variants of PipelinedCompressor
and make_codec_fns against the JAX package's, on the trained model and
its coding statistics."""

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
    make_codec_fns,
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


@pytest.mark.parametrize("fast_path", ["bf16w", "int8"])
def test_pipelined_compressor_variant_matches_jax(fast_path):
    (params_jax, params, bw, mean, probs, idx_exc) = _experiment(LEARNED)
    images = _images()
    kwargs = dict(idx_map_exception=idx_exc, batch_size=2, fast_path=fast_path)
    jax_compressor = jax_inference.PipelinedCompressor(
        params_jax, bw, True, probs, mean, **kwargs)
    (recs_jax, bits_jax) = jax_compressor(images)
    compressor = PipelinedCompressor(params, bw, True, probs, mean, max_in_flight=2,
                                     device="cpu", **kwargs)
    (recs, bits) = compressor(images)
    assert compressor.fast_path == fast_path
    assert recs.shape == recs_jax.shape and recs.dtype == numpy.uint8
    assert bits.shape == (4,) and bits.dtype == numpy.int64

    (sym_jax, _, _) = jax_compressor.encode_symbols_fn(
        jax_compressor.params, jnp.asarray(images), jax_compressor.bin_widths,
        jax_compressor.map_mean)
    (sym, _, _) = compressor.encode_symbols(torch.from_numpy(images))
    (sym, sym_jax) = (sym.numpy(), numpy.asarray(sym_jax))
    flips = float(numpy.mean(sym != sym_jax))
    print(fast_path, "symbol flip rate against JAX", flips)
    # An all-bf16 encoder: the convs' summation order moves activations
    # by bf16 ulps, which flips a symbol here and there, by one.
    assert flips <= 0.02 and numpy.abs(sym.astype(int) - sym_jax.astype(int)).max() <= 1
    for i in range(images.shape[0]):
        # Bits: equal where the symbols are, else within 1 %.
        if numpy.array_equal(sym[i], sym_jax[i]):
            assert bits[i] == bits_jax[i]
        else:
            assert abs(int(bits[i]) - int(bits_jax[i])) <= 0.01 * int(bits_jax[i])
        # PSNR against the original: both packages run a variant that
        # is itself 0.1 to 0.4 dB off the fp32 path on such crops, each
        # with its own realisation of the bf16 roundings (summation
        # order), so two runs of one variant differ by a part of that:
        # within 0.3 dB per image (measured: bf16w 0.014 to 0.104 dB,
        # int8 0.018 to 0.168 dB on these 64 x 96 crops), and the
        # reconstructions 40 dB apart at worst.
        gap = abs(psnr_2d(images[i, :, :, 0], recs[i, :, :, 0])
                  - psnr_2d(images[i, :, :, 0], recs_jax[i, :, :, 0]))
        print(fast_path, "image", i, "PSNR gap against JAX", gap)
        assert gap <= 0.3
        if not numpy.array_equal(recs[i], recs_jax[i]):
            assert psnr_2d(recs_jax[i, :, :, 0], recs[i, :, :, 0]) >= 40.0


def test_int8_variant_keeps_the_store_int8():
    (_, params, bw, mean, probs, idx_exc) = _experiment(LEARNED)
    compressor = PipelinedCompressor(params, bw, True, probs, mean, idx_map_exception=idx_exc,
                                     fast_path="int8", device="cpu")
    for i in range(1, 7):
        entry = compressor.params[f"weights_{i}"]
        assert entry["int8"].dtype == torch.int8 and entry["scale"].dtype == torch.float32
    assert compressor.params["gamma_1"].dtype == torch.float32
    bf16w = PipelinedCompressor(params, bw, True, probs, mean, idx_map_exception=idx_exc,
                                fast_path="bf16w", device="cpu")
    assert all(bf16w.params[f"weights_{i}"].dtype == torch.bfloat16 for i in range(1, 7))


def test_unknown_fast_path_lists_the_three_names():
    (_, params, bw, mean, probs, _) = _experiment(LEARNED)
    with pytest.raises(ValueError) as error:
        PipelinedCompressor(params, bw, True, probs, mean, fast_path="fp8", device="cpu")
    for name in ("'bf16w+'", "'bf16w'", "'int8'"):
        assert name in str(error.value)
    for fast_path in ("bf16w", "int8"):
        with pytest.raises(ValueError, match="learned-bin-width"):
            PipelinedCompressor(params, bw, False, probs, mean, fast_path=fast_path,
                                device="cpu")


@pytest.mark.parametrize("exp_dir,learn_bin_widths", [(LEARNED, True), (FIXED, False)],
                         ids=["learned", "fixed"])
def test_make_codec_fns_matches_roundtrip_batched(exp_dir, learn_bin_widths):
    (_, params, bw, _, _, _) = _experiment(exp_dir)
    images = _images()
    (encode_fn, decode_fn, put) = make_codec_fns(learn_bin_widths, device="cpu")
    batch = put(images.astype(numpy.float32))
    assert torch.is_tensor(batch) and batch.device.type == "cpu"
    latents = encode_fn(params, batch)
    assert latents.shape == (4, 4, 6, 128)
    got = decode_fn(params, latents, torch.from_numpy(bw)).numpy()
    expected = roundtrip_batched(params, images, bw, learn_bin_widths, batch_size=4,
                                 device="cpu")
    if learn_bin_widths:
        # The same operations in the same order.
        numpy.testing.assert_array_equal(got, expected)
    else:
        # roundtrip_batched fuses GDN_3 with the quantiser; on the CPU
        # its plain version is the same two steps.
        numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-3)


def test_make_codec_fns_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="cuda"):
        make_codec_fns(True)
