"""PyTorch port: the fp32 transforms and the bf16w+ serving transforms
against the JAX package's, on the trained weights."""

import os

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.engine import quantized as jax_engine
from autoencoder_based_image_compression_tpu.models import conv_eae as jax_eae
from autoencoder_based_image_compression_tpu.ops.quantization import (
    cast_bt601 as jax_cast_bt601,
)
from autoencoder_based_image_compression_tpu.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = {
    True: os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000"),
    False: os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000"),
}


def _models(learn_bin_widths):
    path = os.path.join(EXPERIMENTS[learn_bin_widths], "params_trained.npz")
    (params_jax, bin_widths) = jax_load_params_artifact(path)
    (params_np, _) = load_params_artifact(path)
    map_mean = numpy.load(os.path.join(EXPERIMENTS[learn_bin_widths], "statistics",
                                       "map_mean.npy")).astype(numpy.float32)
    return (params_jax, params_from_jax(params_np), numpy.asarray(bin_widths), map_mean)


def _images():
    return synthetic_luminance_stack(2, 64, 96, seed=3).astype(numpy.float32)


@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_fp32_encode_matches_jax(learn_bin_widths):
    (params_jax, params, bin_widths, map_mean) = _models(learn_bin_widths)
    images = _images()
    expected = numpy.asarray(jax_eae.encode(params_jax, jnp.asarray(images),
                                            learn_bin_widths))
    got = conv_eae.encode(params, torch.from_numpy(images), learn_bin_widths).numpy()
    assert got.shape == expected.shape == (2, 4, 6, 128)
    # fp32 on both sides (TF32 off on the card); summation order differs.
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-4)
    for multiplier in (1.0, 4.0, 10.0):
        bw = bin_widths * multiplier
        flip_rate = float(numpy.mean(numpy.round((got - map_mean) / bw)
                                     != numpy.round((expected - map_mean) / bw)))
        print(f"symbol_flip_rate_x{multiplier:g}", flip_rate)
        # A flip needs a latent within ~1e-6 of a rounding boundary.
        assert flip_rate <= 1e-4


@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_fp32_decode_matches_jax(learn_bin_widths):
    (params_jax, params, bin_widths, _) = _models(learn_bin_widths)
    y = numpy.asarray(jax_eae.encode(params_jax, jnp.asarray(_images()),
                                     learn_bin_widths))
    quantized = (bin_widths * numpy.round(y / bin_widths)).astype(numpy.float32)
    expected = numpy.asarray(jax_eae.decode(params_jax, jnp.asarray(quantized),
                                            learn_bin_widths))
    got = conv_eae.decode(params, torch.from_numpy(quantized), learn_bin_widths).numpy()
    assert got.shape == expected.shape == (2, 64, 96, 1)
    # Pixels in [0, 255] after three fp32 layers: 1e-5 relative plus an
    # absolute 1e-3 for summation order on values of order 100.
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-3)


def _bf16wplus():
    (params_jax, params, bin_widths, map_mean) = _models(True)
    enc = jax_engine.BF16WPLUS_ENC_TAIL
    dec = jax_engine.BF16WPLUS_DEC_TAIL
    qp_jax = jax_engine.bf16_weight_params(params_jax, fp32_tail=dec,
                                           fp32_enc_tail=enc)
    qp = engine.bf16_weight_params(params, fp32_tail=dec, fp32_enc_tail=enc)
    return (qp_jax, qp, bin_widths, map_mean)


def test_bf16_weight_params_tail_sets():
    (qp_jax, qp, _, _) = _bf16wplus()
    for (name, value) in qp.items():
        assert str(value.dtype) == "torch." + str(qp_jax[name].dtype), name
    assert engine._fp32_tail_names(2) == jax_engine._fp32_tail_names(2)
    assert engine._fp32_enc_tail_names(1) == jax_engine._fp32_enc_tail_names(1)


def test_bf16wplus_encode_matches_jax():
    (qp_jax, qp, _, _) = _bf16wplus()
    images = _images()
    expected = numpy.asarray(jax_engine.fast_encode(
        qp_jax, jnp.asarray(images), learn_bin_widths=True,
        fp32_enc_tail=jax_engine.BF16WPLUS_ENC_TAIL,
        enc_precision=jax_engine.BF16WPLUS_ENC_PRECISION))
    got = engine.fast_encode(qp, torch.from_numpy(images), learn_bin_widths=True,
                             fp32_enc_tail=engine.BF16WPLUS_ENC_TAIL)
    assert got.dtype == torch.float32
    # The bf16w+ encoder is all fp32 (space-to-depth conv_1; true fp32
    # on the card, at least as tight as the reference's "high"): the
    # same tolerance as the fp32 path.
    numpy.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-4)


def test_bf16wplus_decode_matches_jax():
    (qp_jax, qp, bin_widths, map_mean) = _bf16wplus()
    rng = numpy.random.default_rng(4)
    symbols = rng.integers(-3, 4, size=(2, 4, 6, 128)).astype(numpy.float32)
    latents = (symbols * bin_widths + map_mean).astype(numpy.float32)
    expected = numpy.asarray(jax_cast_bt601(jax_engine.fast_decode(
        qp_jax, jnp.asarray(latents), fp32_tail=jax_engine.BF16WPLUS_DEC_TAIL)))
    got = cast_bt601(engine.fast_decode(
        qp, torch.from_numpy(latents), fp32_tail=engine.BF16WPLUS_DEC_TAIL)).numpy()
    assert got.shape == expected.shape == (2, 64, 96, 1)
    psnrs = [psnr_2d(expected[i, :, :, 0], got[i, :, :, 0])
             if not numpy.array_equal(expected[i], got[i]) else 99.0
             for i in range(2)]
    within_one = float(numpy.mean(numpy.abs(got.astype(int) - expected.astype(int)) <= 1))
    print("psnr_vs_jax_db", min(psnrs))
    print("share_within_1_level", within_one)
    # Both round at the same bf16 sites (weights, tconv_4/5 outputs, the
    # bias adds, the IGDN outputs); summation order inside the bf16
    # convs moves some of those roundings by one bf16 ulp.
    assert min(psnrs) >= 50.0
    assert within_one >= 0.999


def test_space_to_depth_forms_match_jax():
    rng = numpy.random.default_rng(5)
    x = rng.normal(size=(2, 32, 48, 1)).astype(numpy.float32)
    y = rng.normal(size=(2, 8, 12, 128)).astype(numpy.float32)
    w9 = rng.normal(size=(9, 9, 1, 128)).astype(numpy.float32)
    w9_t = torch.from_numpy(w9).permute(3, 2, 0, 1).contiguous()
    expected = numpy.asarray(jax_engine._conv1_s2d(jnp.asarray(x), jnp.asarray(w9),
                                                   dtype=jnp.float32))
    got = engine._conv1_s2d(torch.from_numpy(x), w9_t, dtype=torch.float32).numpy()
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-4)
    expected = numpy.asarray(jax_engine._tconv6_s2d(jnp.asarray(y), jnp.asarray(w9),
                                                    dtype=jnp.float32))
    got = engine._tconv6_s2d(torch.from_numpy(y), w9_t, dtype=torch.float32).numpy()
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-4)
    # And the s2d forms equal the plain strided conv / its transpose.
    numpy.testing.assert_allclose(
        engine._conv1_s2d(torch.from_numpy(x), w9_t, dtype=torch.float32).numpy(),
        conv_eae.conv_same(torch.from_numpy(x), w9_t, 4).numpy(), rtol=1e-5, atol=1e-4)


def test_fp32_head_brings_decode_closer_to_fp32():
    (_, qp, bin_widths, map_mean) = _bf16wplus()
    (_, params, _, _) = _models(True)
    y = conv_eae.encode(params, torch.from_numpy(_images()), True)
    bw = torch.tensor(bin_widths)
    mean = torch.from_numpy(map_mean)
    latents = torch.round((y - mean) / bw) * bw + mean
    reference = cast_bt601(conv_eae.decode(params, latents, True)).numpy()
    psnrs = {}
    for head in (False, True):
        got = cast_bt601(engine.fast_decode(qp, latents, fp32_head=head)).numpy()
        psnrs[head] = min(psnr_2d(reference[i, :, :, 0], got[i, :, :, 0]) for i in range(2))
    print("psnr_vs_fp32_decode", psnrs)
    # The bf16 rounding of tconv_4's output is the decoder's largest
    # error site: keeping it fp32 moves the decode towards fp32.
    assert psnrs[True] > psnrs[False]


def test_fold_bin_widths_into_decoder_matches_jax():
    (params_jax, params, bin_widths, _) = _models(True)
    for multiplier in (1.0, 10.0):
        bw = (bin_widths * multiplier).astype(numpy.float32)
        expected = jax_engine.fold_bin_widths_into_decoder(params_jax, bw)
        got = engine.fold_bin_widths_into_decoder(params, bw)
        assert set(got) == set(expected)
        # JAX keeps weights_4 as (kh, kw, out, in), the port as
        # (in, out, kh, kw): one fp32 product per element on both sides.
        numpy.testing.assert_allclose(
            got["weights_4"].numpy(),
            numpy.asarray(expected["weights_4"]).transpose(3, 2, 0, 1), rtol=1e-6)
        for name in ("weights_5", "weights_6", "gamma_5", "biases_4"):
            assert got[name] is params[name]
    # Linear in the symbols: folding then decoding integer symbols equals
    # decoding the dequantised symbols (fp32; only the order of the
    # products differs).
    y = conv_eae.encode(params, torch.from_numpy(_images()), True)
    symbols = torch.round(y / torch.tensor(bin_widths))
    torch.testing.assert_close(
        conv_eae.decode(engine.fold_bin_widths_into_decoder(params, bin_widths),
                        symbols, True),
        conv_eae.decode(params, symbols * torch.tensor(bin_widths), True),
        rtol=1e-5, atol=1e-3)


def test_fold_bin_widths_into_decoder_refuses_fixed_bin_widths():
    (params_jax, params, bin_widths, _) = _models(False)
    assert "gamma_4" in params
    with pytest.raises(ValueError, match="learned-bin-width"):
        engine.fold_bin_widths_into_decoder(params, bin_widths)
    with pytest.raises(ValueError, match="learned-bin-width"):
        jax_engine.fold_bin_widths_into_decoder(params_jax, bin_widths)


@pytest.mark.parametrize("fp32_tail", [0, 3])
def test_folded_symbol_decode_matches_jax(fp32_tail):
    (params_jax, params, bin_widths, _) = _models(True)
    y = numpy.asarray(jax_eae.encode(params_jax, jnp.asarray(_images()), True))
    symbols = numpy.round(y / bin_widths).astype(numpy.float32)
    qp_jax = jax_engine.bf16_weight_params(
        jax_engine.fold_bin_widths_into_decoder(params_jax, bin_widths),
        fp32_tail=fp32_tail)
    qp = engine.bf16_weight_params(
        engine.fold_bin_widths_into_decoder(params, bin_widths), fp32_tail=fp32_tail)
    expected = numpy.asarray(jax_engine.fast_decode(qp_jax, jnp.asarray(symbols),
                                                    fp32_tail=fp32_tail))
    got = engine.fast_decode(qp, torch.from_numpy(symbols), fp32_tail=fp32_tail).numpy()
    assert got.shape == expected.shape == (2, 64, 96, 1)
    if fp32_tail == 3:
        # All fp32 on both sides: the fp32 decode's tolerance.
        numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-3)
        return
    (got, expected) = (cast_bt601(got), numpy.asarray(jax_cast_bt601(expected)))
    psnrs = [psnr_2d(expected[i, :, :, 0], got[i, :, :, 0])
             if not numpy.array_equal(expected[i], got[i]) else 99.0 for i in range(2)]
    within_one = float(numpy.mean(numpy.abs(got.astype(int) - expected.astype(int)) <= 1))
    print("psnr_vs_jax_db", min(psnrs))
    print("share_within_1_level", within_one)
    # The same bf16 rounding sites as test_bf16wplus_decode_matches_jax,
    # and the same bounds (measured here: 59.19 dB, all within one level).
    assert min(psnrs) >= 50.0
    assert within_one >= 0.999


@pytest.mark.parametrize("multiplier", [1.0, 4.0, 10.0])
def test_bf16wplus_mix_inside_gate_against_fp32_decode(multiplier):
    (_, params, bin_widths, map_mean) = _models(True)
    images = synthetic_luminance_stack(4, 128, 192, seed=11)
    y = conv_eae.encode(params, torch.from_numpy(images.astype(numpy.float32)), True)
    bw = torch.from_numpy((bin_widths * multiplier).astype(numpy.float32))
    mean = torch.from_numpy(map_mean)
    latents = torch.round((y - mean) / bw) * bw + mean
    reference = cast_bt601(conv_eae.decode(params, latents, True)).numpy()
    qp = engine.bf16_weight_params(params, fp32_tail=engine.BF16WPLUS_DEC_TAIL)
    got = cast_bt601(engine.fast_decode(
        qp, latents, fp32_tail=engine.BF16WPLUS_DEC_TAIL,
        fp32_head=engine.BF16WPLUS_DEC_HEAD,
        exact_latents=engine.BF16WPLUS_DEC_EXACT_LATENTS)).numpy()
    deltas = [psnr_2d(images[i, :, :, 0], got[i, :, :, 0])
              - psnr_2d(images[i, :, :, 0], reference[i, :, :, 0]) for i in range(4)]
    print("worst_image_delta_db", min(deltas))
    # The serving gate: the worst image at most 0.05 dB under the fp32
    # decode. Measured on these crops on the CPU: +0.0100 dB at x1,
    # +0.0018 at x4, -0.0241 at x10 (small crops move more than the
    # 512 x 768 images of the on-card check).
    assert min(deltas) >= -0.05
