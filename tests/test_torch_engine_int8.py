"""PyTorch port: the int8 weight-only store and the fast transforms over
it against the JAX package's, on the trained weights; the plain strided
forms of conv_1 / tconv_6 against their space-to-depth forms."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.engine import quantized as jax_engine
from autoencoder_based_image_compression_tpu.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu.ops.quantization import (
    cast_bt601 as jax_cast_bt601,
)
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    int8_params_from_jax,
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = {
    "learned": os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000"),
    "fixed": os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000"),
}


def _models(which):
    path = os.path.join(EXPERIMENTS[which], "params_trained.npz")
    (params_jax, bin_widths) = jax_load_params_artifact(path)
    (params_np, _) = load_params_artifact(path)
    return (params_jax, params_from_jax(params_np), numpy.asarray(bin_widths))


def _as_numpy(qparams_jax):
    return {name: ({key: numpy.asarray(leaf) for (key, leaf) in value.items()}
                   if isinstance(value, dict) else numpy.asarray(value))
            for (name, value) in qparams_jax.items()}


def _images():
    return synthetic_luminance_stack(2, 64, 96, seed=3).astype(numpy.float32)


def _assert_same_store(got, expected_jax):
    expected = int8_params_from_jax(_as_numpy(expected_jax))
    assert set(got) == set(expected)
    for name in csts.CONV_NAMES:
        assert got[name]["int8"].dtype == torch.int8
        assert got[name]["scale"].dtype == torch.float32
        assert got[name]["scale"].shape == expected[name]["scale"].shape
        # The same fp32 operations on the same numbers: equal exactly.
        assert torch.equal(got[name]["int8"], expected[name]["int8"]), name
        assert torch.equal(got[name]["scale"], expected[name]["scale"]), name
    for name in set(got) - set(csts.CONV_NAMES):
        assert torch.equal(got[name], expected[name]), name


@pytest.mark.parametrize("which", ["learned", "fixed"])
def test_int8_entries_and_scales_equal_jax(which):
    (params_jax, params, _) = _models(which)
    got = engine.quantize_params_int8(params)
    _assert_same_store(got, jax_engine.quantize_params_int8(params_jax))
    # One scale per output channel: axis 0 of an encoder kernel (OIHW),
    # axis 1 of a decoder kernel (in, out, kh, kw).
    assert got["weights_2"]["scale"].shape == (128, 1, 1, 1)
    assert got["weights_5"]["scale"].shape == (1, 128, 1, 1)
    assert got["weights_6"]["scale"].shape == (1, 1, 1, 1)


@pytest.mark.parametrize("which", ["learned", "fixed"])
def test_dequantised_kernels_equal_jax(which):
    (params_jax, params, _) = _models(which)
    expected = jax_engine.dequantize_int8_params(jax_engine.quantize_params_int8(params_jax))
    got = engine.dequantize_int8_params(engine.quantize_params_int8(params))
    for name in csts.CONV_NAMES:
        assert got[name].dtype == torch.bfloat16
        want = numpy.asarray(expected[name].astype(jnp.float32)).transpose(3, 2, 0, 1)
        # int8 * fp32 scale, rounded to bf16 once, on both sides.
        numpy.testing.assert_array_equal(got[name].to(torch.float32).numpy(), want)
    # Plain tensors pass through: the bf16 store is left alone.
    plain = engine.bf16_weight_params(params)
    assert all(value is plain[name]
               for (name, value) in engine.dequantize_int8_params(plain).items())


def test_fold_then_quantise_equals_jax():
    (params_jax, params, bin_widths) = _models("learned")
    for multiplier in (1.0, 10.0):
        bw = (bin_widths * multiplier).astype(numpy.float32)
        expected = jax_engine.quantize_params_int8(
            jax_engine.fold_bin_widths_into_decoder(params_jax, bw))
        got = engine.quantize_params_int8(engine.fold_bin_widths_into_decoder(params, bw))
        _assert_same_store(got, expected)
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, "int8")
    assert knobs == {}
    _assert_same_store(qparams, jax_engine.quantize_params_int8(params_jax))
    _assert_same_store(qfolded, jax_engine.quantize_params_int8(
        jax_engine.fold_bin_widths_into_decoder(params_jax, bin_widths)))


def test_int8_fast_encode_matches_jax():
    (params_jax, params, bin_widths) = _models("learned")
    images = _images()
    expected = numpy.asarray(jax_engine.fast_encode(
        jax_engine.quantize_params_int8(params_jax), jnp.asarray(images)))
    got = engine.fast_encode(engine.quantize_params_int8(params),
                             torch.from_numpy(images)).numpy()
    assert got.shape == expected.shape == (2, 4, 6, 128) and got.dtype == numpy.float32
    # All-bf16 activations: equal kernels, equal rounding sites, another
    # summation order inside the convs, which moves a bf16 activation by
    # an ulp (2^-8 relative) here and there. Latents reach some 60 in
    # magnitude; the gap stays a small part of a bin width.
    gap = numpy.abs(got - expected)
    print("int8 fast_encode: max gap", gap.max(), "mean gap", gap.mean())
    assert gap.max() <= 0.25 * bin_widths.min()
    assert gap.mean() <= 0.01
    flips = numpy.mean(numpy.round(got / bin_widths) != numpy.round(expected / bin_widths))
    print("int8 fast_encode: symbol flip rate", flips)
    assert flips <= 0.02


def test_int8_fast_decode_matches_jax():
    (params_jax, params, bin_widths) = _models("learned")
    rng = numpy.random.default_rng(4)
    symbols = rng.integers(-3, 4, size=(2, 4, 6, 128)).astype(numpy.float32)
    expected = numpy.asarray(jax_cast_bt601(jax_engine.fast_decode(
        jax_engine.quantize_params_int8(
            jax_engine.fold_bin_widths_into_decoder(params_jax, bin_widths)),
        jnp.asarray(symbols))))
    (_, qfolded, _) = engine.scan_variant(params, bin_widths, "int8")
    got = cast_bt601(engine.fast_decode(qfolded, torch.from_numpy(symbols))).numpy()
    assert got.shape == expected.shape == (2, 64, 96, 1)
    psnrs = [psnr_2d(expected[i, :, :, 0], got[i, :, :, 0])
             if not numpy.array_equal(expected[i], got[i]) else 99.0 for i in range(2)]
    within_one = float(numpy.mean(numpy.abs(got.astype(int) - expected.astype(int)) <= 1))
    print("psnr_vs_jax_db", min(psnrs), "share_within_1_level", within_one)
    # The bounds of the bf16 decode (tests/test_torch_transforms.py): the
    # same rounding sites, bf16 ulps moved by summation order.
    assert min(psnrs) >= 50.0
    assert within_one >= 0.999


@pytest.mark.parametrize("store", ["int8", "bf16w"])
def test_fast_path_s2d_matches_plain(store):
    (_, params, bin_widths) = _models("learned")
    (qparams, qfolded, _) = engine.scan_variant(params, bin_widths, store)
    batch = torch.from_numpy(_images())
    y_plain = engine.fast_encode(qparams, batch, use_s2d=False)
    y_s2d = engine.fast_encode(qparams, batch, use_s2d=True)
    # The tolerance of tests/test_engine.py::test_fast_path_s2d_matches_plain.
    numpy.testing.assert_allclose(y_s2d.numpy(), y_plain.numpy(), rtol=1e-2, atol=2e-2)
    symbols = torch.round(y_plain / torch.from_numpy(bin_widths))
    rec_plain = engine.fast_decode(qfolded, symbols, use_s2d=False)
    rec_s2d = engine.fast_decode(qfolded, symbols, use_s2d=True)
    numpy.testing.assert_allclose(rec_s2d.numpy(), rec_plain.numpy(), rtol=1e-2, atol=2e-2)


def test_s2d_kernel_is_built_without_host_lists():
    rng = numpy.random.default_rng(5)
    w9 = torch.from_numpy(rng.normal(size=(128, 1, 9, 9)).astype(numpy.float32))
    wk = engine._s2d_kernel_from_conv1(w9)
    # Tap (t_h, t_w) lands in block (1 + (t - 2) // 4) at position (t - 2) % 4.
    for (t_h, t_w) in ((0, 0), (2, 2), (5, 7), (8, 8)):
        (a_h, j_h) = (1 + (t_h - 2) // 4, (t_h - 2) % 4)
        (a_w, j_w) = (1 + (t_w - 2) // 4, (t_w - 2) % 4)
        assert torch.equal(wk[:, j_h * 4 + j_w, a_h, a_w], w9[:, 0, t_h, t_w])
    assert int((wk != 0).sum()) == int((w9 != 0).sum())
    # The index is made once per device and reused.
    assert engine._s2d_tap_index(w9.device) is engine._s2d_tap_index(w9.device)
