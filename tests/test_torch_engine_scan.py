"""PyTorch port: the fixed-bin-width fast decode and the K-batch round
trip against the JAX package's, on the trained weights."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.engine import quantized as jax_engine
from autoencoder_based_image_compression_tpu.models import conv_eae as jax_eae
from autoencoder_based_image_compression_tpu.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu.ops.quantization import (
    cast_bt601 as jax_cast_bt601,
)
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
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")


def _models(exp_dir):
    path = os.path.join(exp_dir, "params_trained.npz")
    (params_jax, bin_widths) = jax_load_params_artifact(path)
    (params_np, _) = load_params_artifact(path)
    return (params_jax, params_from_jax(params_np), numpy.array(bin_widths, numpy.float32))


def _stack(nb_scan=2):
    """(K, 2, 64, 96, 1) fp32: distinct batches."""
    images = synthetic_luminance_stack(2 * nb_scan, 64, 96, seed=3).astype(numpy.float32)
    return images.reshape(nb_scan, 2, 64, 96, 1)


def _bf16_close(got_u8, expected_u8):
    """The bounds of a bf16 decode against JAX's (as in
    tests/test_torch_transforms.py): the same rounding sites, bf16 ulps
    moved by the convs' summation order."""
    psnrs = [psnr_2d(expected_u8[i, :, :, 0], got_u8[i, :, :, 0])
             if not numpy.array_equal(expected_u8[i], got_u8[i]) else 99.0
             for i in range(got_u8.shape[0])]
    within_one = float(numpy.mean(
        numpy.abs(got_u8.astype(int) - expected_u8.astype(int)) <= 1))
    print("psnr_vs_jax_db", min(psnrs), "share_within_1_level", within_one)
    assert min(psnrs) >= 50.0
    assert within_one >= 0.999


@pytest.mark.parametrize("fp32_tail", [0, 3])
def test_fast_decode_fixed_bw_matches_jax(fp32_tail):
    (params_jax, params, bin_widths) = _models(FIXED)
    images = _stack(1)[0]
    y = numpy.asarray(jax_eae.encode(params_jax, jnp.asarray(images), False))
    symbols = numpy.round(y / bin_widths).astype(numpy.float32)
    expected = numpy.asarray(jax_engine.fast_decode_fixed_bw(
        jax_engine.bf16_weight_params(params_jax, fp32_tail=fp32_tail),
        jnp.asarray(symbols), jnp.asarray(bin_widths), fp32_tail=fp32_tail))
    got = engine.fast_decode_fixed_bw(
        engine.bf16_weight_params(params, fp32_tail=fp32_tail), torch.from_numpy(symbols),
        bin_widths, fp32_tail=fp32_tail).numpy()
    assert got.shape == expected.shape == (2, 64, 96, 1) and got.dtype == numpy.float32
    if fp32_tail == 3:
        # All fp32 on both sides: the fp32 decode's tolerance, also
        # against the parity transform on the dequantised symbols.
        numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-3)
        parity = conv_eae.decode(params, torch.from_numpy(symbols * bin_widths), False)
        numpy.testing.assert_allclose(got, parity.numpy(), rtol=1e-5, atol=1e-3)
        return
    _bf16_close(cast_bt601(got), numpy.asarray(jax_cast_bt601(expected)))


def test_fast_decode_fixed_bw_takes_the_int8_store_and_both_tconv6_forms():
    (_, params, bin_widths) = _models(FIXED)
    y = conv_eae.encode(params, torch.from_numpy(_stack(1)[0]), False)
    symbols = torch.round(y / torch.from_numpy(bin_widths))
    qparams = engine.quantize_params_int8(params)
    s2d = engine.fast_decode_fixed_bw(qparams, symbols, bin_widths)
    plain = engine.fast_decode_fixed_bw(qparams, symbols, bin_widths, use_s2d=False)
    numpy.testing.assert_allclose(s2d.numpy(), plain.numpy(), rtol=1e-2, atol=2e-2)
    reference = conv_eae.decode(params, symbols * torch.from_numpy(bin_widths), False)
    # int8 kernels and bf16 activations against the fp32 decode: the
    # band tests/test_engine.py gives a fast variant on image content.
    assert min(psnr_2d(cast_bt601(reference).numpy()[i, :, :, 0],
                       cast_bt601(s2d).numpy()[i, :, :, 0]) for i in range(2)) >= 35.0


@pytest.mark.parametrize("variant", ["bf16w", "bf16w+", "int8"])
def test_fast_roundtrip_scan_matches_jax(variant):
    (params_jax, params, bin_widths) = _models(LEARNED)
    stack = _stack(2)
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, variant)
    (recs, symbols) = engine.fast_roundtrip_scan(
        qparams, qfolded, torch.from_numpy(stack), bin_widths, **knobs)
    assert recs.shape == (2, 2, 64, 96, 1) and symbols.shape == (2, 2, 4, 6, 128)
    assert recs.dtype == symbols.dtype == torch.float32
    assert torch.equal(symbols, torch.round(symbols))

    # The reference's own mix of the variant: its bf16w+ has no fp32
    # tconv_4, which the port's scan path adds on the card's evidence.
    (enc, dec) = ((jax_engine.BF16WPLUS_ENC_TAIL, jax_engine.BF16WPLUS_DEC_TAIL)
                  if variant == "bf16w+" else (0, 0))
    folded_jax = jax_engine.fold_bin_widths_into_decoder(params_jax, bin_widths)
    if variant == "int8":
        (qp_jax, qf_jax) = (jax_engine.quantize_params_int8(params_jax),
                            jax_engine.quantize_params_int8(folded_jax))
    else:
        (qp_jax, qf_jax) = (jax_engine.bf16_weight_params(params_jax, fp32_enc_tail=enc),
                            jax_engine.bf16_weight_params(folded_jax, fp32_tail=dec))
    (recs_jax, symbols_jax) = jax_engine.fast_roundtrip_scan(
        qp_jax, qf_jax, jnp.asarray(stack), jnp.asarray(bin_widths), fp32_tail=dec,
        fp32_enc_tail=enc)
    (recs_jax, symbols_jax) = (numpy.asarray(recs_jax), numpy.asarray(symbols_jax))

    # Symbols: equal wherever JAX's latent is not within 1e-3 bin widths
    # of a rounding boundary, for the fp32 encoder of bf16w+ (summation
    # order moves a latent by ~1e-5). A bf16 encoder moves latents by
    # bf16 ulps of the activations: a flip rate is stated instead.
    y_jax = numpy.concatenate([numpy.asarray(jax_engine.fast_encode(
        qp_jax, jnp.asarray(batch), fp32_enc_tail=enc)) for batch in stack])
    scaled = y_jax.reshape(symbols_jax.shape) / bin_widths
    near_boundary = numpy.abs(numpy.abs(scaled - numpy.floor(scaled)) - 0.5) < 1e-3
    differ = symbols.numpy() != symbols_jax
    print(variant, "symbols that differ:", int(differ.sum()), "of", differ.size,
          "; near a boundary:", int(near_boundary.sum()))
    if variant == "bf16w+":
        assert not numpy.any(differ & ~near_boundary)
        assert near_boundary.mean() <= 5e-3
    else:
        assert differ.mean() <= 0.02
        assert numpy.abs(symbols.numpy() - symbols_jax).max() <= 1.0

    # Reconstructions: where every symbol of a batch agrees, the decoders
    # see the same input and differ by bf16 ulps; otherwise both are
    # held to the fp32 decode of their own symbols (35 dB: the band of
    # tests/test_engine.py for a fast variant).
    for k in range(stack.shape[0]):
        got = cast_bt601(recs[k]).numpy()
        if not differ[k].any():
            _bf16_close(got, numpy.asarray(jax_cast_bt601(recs_jax[k])))
        reference = cast_bt601(conv_eae.decode(
            params, symbols[k] * torch.from_numpy(bin_widths), True)).numpy()
        assert min(psnr_2d(reference[i, :, :, 0], got[i, :, :, 0]) for i in range(2)) >= 35.0


@pytest.mark.parametrize("variant", ["bf16w", "bf16w+", "int8"])
def test_fast_roundtrip_scan_equals_per_batch_calls(variant):
    (_, params, bin_widths) = _models(LEARNED)
    stack = torch.from_numpy(_stack(3))
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, variant)
    (recs, symbols) = engine.fast_roundtrip_scan(qparams, qfolded, stack, bin_widths, **knobs)
    decode_knobs = {key: value for (key, value) in knobs.items() if key != "fp32_enc_tail"}
    bw = torch.from_numpy(bin_widths)
    for k in range(3):
        y = engine.fast_encode(qparams, stack[k], fp32_enc_tail=knobs.get("fp32_enc_tail", 0))
        assert torch.equal(symbols[k], torch.round(y / bw))
        assert torch.equal(recs[k], engine.fast_decode(qfolded, symbols[k], **decode_knobs))


def test_fast_roundtrip_scan_graph_raises_on_the_cpu():
    (_, params, bin_widths) = _models(LEARNED)
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, "bf16w+")
    with pytest.raises(RuntimeError, match="graph=True"):
        engine.fast_roundtrip_scan(qparams, qfolded, torch.from_numpy(_stack(1)),
                                   torch.from_numpy(bin_widths), graph=True, **knobs)


def test_scan_variant_names_and_knobs():
    (_, params, bin_widths) = _models(LEARNED)
    with pytest.raises(ValueError, match="bf16w\\+"):
        engine.scan_variant(params, bin_widths, "fp8")
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, "bf16w+")
    assert knobs == engine.BF16WPLUS_SCAN_MIX and knobs is not engine.BF16WPLUS_SCAN_MIX
    # The analysis transform is fp32, and so is the folded kernel when
    # the mix says so; the later decoder kernels are bf16.
    assert all(qparams[f"weights_{i}"].dtype == torch.float32 for i in (1, 2, 3))
    assert qfolded["weights_4"].dtype == (
        torch.float32 if knobs.get("fp32_tconv4") else torch.bfloat16)
    assert qfolded["weights_5"].dtype == qfolded["weights_6"].dtype == torch.bfloat16


def test_no_serving_decode_sets_cudnn_deterministic(monkeypatch):
    """``torch.backends.cudnn.deterministic`` belongs to the whole
    process: a decode that set it would hand every other thread's
    convolutions (and any CUDA graph captured meanwhile) cuDNN's slow
    deterministic algorithms. No serving decode sets it, and it is False
    at every convolution of each: the fast decodes of the three scan
    variants, both ``fast_decode_fixed_bw`` tails, the K-batch round
    trip and the pipeline's bf16w+ decode."""
    module = type(torch.backends.cudnn)
    flag = module.__dict__["deterministic"]
    (sets, seen) = ([], [])

    class Recording:
        def __get__(self, obj, objtype=None):
            return flag.__get__(obj, objtype)

        def __set__(self, obj, value):
            sets.append(value)
            flag.__set__(obj, value)

    def recording(conv):
        def call(*args, **kwargs):
            seen.append(torch.backends.cudnn.deterministic)
            return conv(*args, **kwargs)
        return call

    monkeypatch.setattr(module, "deterministic", Recording())
    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(engine.F, name, recording(getattr(engine.F, name)))
    (_, params, bin_widths) = _models(LEARNED)
    symbols = torch.zeros((1, 2, 2, 128))
    for variant in ("bf16w+", "bf16w", "int8"):
        (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, variant)
        engine.fast_decode(qfolded, symbols, fp32_tconv4=knobs.get("fp32_tconv4", False))
        engine.fast_roundtrip_scan(qparams, qfolded, torch.from_numpy(_stack(1)[:, :1, :32, :32]),
                                   bin_widths, **knobs)
    engine.fast_decode(engine.bf16_weight_params(params), symbols, fp32_head=True,
                       exact_latents=True)
    (_, fixed, fixed_bw) = _models(FIXED)
    for fp32_tail in (0, 3):
        engine.fast_decode_fixed_bw(engine.bf16_weight_params(fixed, fp32_tail=fp32_tail),
                                    symbols, fixed_bw, fp32_tail=fp32_tail)
    assert sets == []
    assert len(seen) >= 30 and not any(seen)


@pytest.mark.parametrize("size", [(4, 6), (5, 7)], ids=["even", "odd"])
@pytest.mark.parametrize("mix", ["fp32", "bf16 kernel, fp32 result", "bf16"])
def test_tconv4_phases_equal_the_transposed_conv(size, mix):
    """tconv_4 as a forward conv into its four output phases then
    depth-to-space, against ``conv_transpose2d`` with the TF-SAME crop,
    in each dtype a serving mix runs it in: fp32 operands (the scan
    path's folded kernel), a bf16 kernel into an fp32 result on the
    unrounded latent (the pipeline's bf16w+), all bf16 ("bf16w", "int8").
    rtol 1e-5 with an atol of 1e-5 of the largest output (sums of 1,152
    products in another order), and for a bf16 result one bf16 ulp more
    (the two sums may round to neighbouring bf16 numbers)."""
    (dtype, out_dtype, round_input) = {
        "fp32": (torch.float32, torch.float32, True),
        "bf16 kernel, fp32 result": (torch.bfloat16, torch.float32, False),
        "bf16": (torch.bfloat16, torch.bfloat16, True)}[mix]
    (_, params, _) = _models(LEARNED)
    generator = torch.Generator().manual_seed(sum(size))
    y = 3.0 * torch.randn((2, *size, 128), generator=generator)
    w5 = params["weights_4"]
    got = engine._tconv4_phases(y, w5, out_dtype=out_dtype, dtype=dtype,
                                round_input=round_input)
    expected = engine._tconv_bf16(y, w5, 2, out_dtype=out_dtype, dtype=dtype,
                                  round_input=round_input)
    assert got.shape == expected.shape == (2, 2 * size[0], 2 * size[1], 128)
    assert got.dtype == expected.dtype == out_dtype
    (got, expected) = (got.float(), expected.float())
    rtol = 1e-5 + (2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got, expected, rtol=rtol, atol=1e-5 * float(expected.abs().max()))


def test_tconv4_phase_kernel_is_built_once_per_kernel_tensor():
    """The phase kernel is kept for the tensor it was built from (no
    gather, no index copy per decode) and built again when that tensor is
    written to."""
    w5 = torch.randn((8, 6, 5, 5), generator=torch.Generator().manual_seed(0))
    first = engine._tconv4_phase_kernel(w5)
    assert first.shape == (24, 8, 3, 3)
    assert engine._tconv4_phase_kernel(w5) is first
    w5.mul_(2.0)
    again = engine._tconv4_phase_kernel(w5)
    assert again is not first and torch.equal(again, 2.0 * first)
    # Phase (0, 0) takes the odd taps (3, 1) at offsets (0, 1) and none at 2.
    assert torch.equal(first[:6, :, 1, 1], (w5[:, :, 1, 1] / 2.0).t())
    assert torch.equal(first[:6, :, 0, 0], (w5[:, :, 3, 3] / 2.0).t())
    assert not bool(first[:6, :, 2, :].any()) and not bool(first[:6, :, :, 2].any())


def test_deterministic_cudnn_overlapping_on_two_threads_restores_the_flag():
    """The flag belongs to the process. Two threads whose contexts
    overlap and leave in the order they entered (A in, B in, A out,
    B out) must find it as it was: a plain save-and-restore per context
    would leave it True for good."""
    import threading

    from autoencoder_based_image_compression_tpu_torch.utils.device import deterministic_cudnn

    (a_in, b_in, a_out) = (threading.Event(), threading.Event(), threading.Event())
    seen = {}

    def first():
        with deterministic_cudnn():
            a_in.set()
            assert b_in.wait(30)
        seen["after the first left"] = torch.backends.cudnn.deterministic
        a_out.set()

    def second():
        assert a_in.wait(30)
        with deterministic_cudnn():
            b_in.set()
            assert a_out.wait(30)
            seen["inside the second"] = torch.backends.cudnn.deterministic

    assert torch.backends.cudnn.deterministic is False
    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(60)
    assert not any(thread.is_alive() for thread in threads)
    # Still held while the second context is open, put back after it.
    assert seen == {"after the first left": True, "inside the second": True}
    assert torch.backends.cudnn.deterministic is False
    with deterministic_cudnn():
        with deterministic_cudnn():
            assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.deterministic is False


@pytest.mark.cuda
def test_serving_decode_repeats_its_bits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CPU's convolutions are deterministic anyway")
    (_, params, bin_widths) = _models(LEARNED)
    params = {name: value.cuda() for (name, value) in params.items()}
    symbols = torch.round(4.0 * torch.randn((4, 32, 48, 128),
                                            generator=torch.Generator().manual_seed(0))).cuda()
    (_, qfolded, knobs) = engine.scan_variant(params, torch.from_numpy(bin_widths).cuda(),
                                              "bf16w+")
    first = engine.fast_decode(qfolded, symbols, fp32_tconv4=knobs["fp32_tconv4"])
    assert all(torch.equal(first, engine.fast_decode(qfolded, symbols,
                                                     fp32_tconv4=knobs["fp32_tconv4"]))
               for _ in range(3))


@pytest.mark.cuda
def test_fast_roundtrip_scan_graph_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    (_, params, bin_widths) = _models(LEARNED)
    params = {name: value.cuda() for (name, value) in params.items()}
    bw = torch.from_numpy(bin_widths).cuda()
    stack = torch.from_numpy(_stack(2)).cuda()
    (qparams, qfolded, knobs) = engine.scan_variant(params, bw, "bf16w+")
    eager = engine.fast_roundtrip_scan(qparams, qfolded, stack, bw, **knobs)
    for _ in range(2):  # the capture, then a replay of it
        replayed = engine.fast_roundtrip_scan(qparams, qfolded, stack, bw, graph=True, **knobs)
        assert torch.equal(replayed[0], eager[0]) and torch.equal(replayed[1], eager[1])
    engine.clear_scan_graphs()
