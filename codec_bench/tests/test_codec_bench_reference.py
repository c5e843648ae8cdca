"""The plain reference against the port's CPU path at a tiny size."""

import os

import numpy
import pytest
import torch

from codec_bench import harness, synthetic, training
from codec_bench.reference import codec, rate
from codec_bench.reference import training as reference

LEARNED = os.path.join(harness.ROOT, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(harness.ROOT, "results", "eae", "fixed_bw", "1_10000")


def _images(count=2, height=64, width=96, seed=3):
    generator = torch.Generator("cpu").manual_seed(seed)
    return synthetic.luminance_stack(count, height, width, generator, "cpu").numpy()


@pytest.mark.parametrize("exp_dir", [LEARNED, FIXED])
def test_transforms_match_the_port(exp_dir):
    from autoencoder_based_image_compression_tpu_torch.eval.workload import load_model
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae

    (params, bin_widths, map_mean, _, _) = load_model(exp_dir)
    learn = "gamma_3" not in params
    (ref_params, ref_bw) = codec.load_params(os.path.join(exp_dir, "params_trained.npz"), "cpu")
    assert torch.equal(ref_bw, torch.as_tensor(bin_widths))
    images = _images()
    x = torch.as_tensor(images).to(torch.float32)
    with torch.no_grad():
        y_port = conv_eae.encode(params, x, learn)
        y_ref = codec.encode(ref_params, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        torch.testing.assert_close(y_ref, y_port, rtol=1e-5, atol=1e-4)
        rec_port = conv_eae.decode(params, torch.round(y_port), learn)
        rec_ref = codec.decode(ref_params, torch.round(y_port).permute(0, 3, 1, 2))
        torch.testing.assert_close(rec_ref.permute(0, 2, 3, 1), rec_port, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("exp_dir", [LEARNED, FIXED])
def test_bits_equal_the_ports_coder(exp_dir):
    from autoencoder_based_image_compression_tpu_torch.eval.workload import load_model
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )

    (params, bin_widths, map_mean, probabilities, idx_exception) = load_model(exp_dir)
    learn = "gamma_3" not in params
    images = _images(4)
    compressor = PipelinedCompressor(params, bin_widths, learn, probabilities, map_mean,
                                     idx_map_exception=idx_exception, batch_size=2,
                                     device="cpu")
    (recs, bits) = compressor(images)
    (ref_params, ref_bw) = codec.load_params(os.path.join(exp_dir, "params_trained.npz"), "cpu")
    (mean, probs, exception) = codec.load_statistics(exp_dir)
    assert exception == idx_exception
    (symbols, ref_recs) = codec.roundtrip(ref_params, ref_bw, mean, images, 2)
    numpy.testing.assert_array_equal(rate.image_bits(symbols, probs, exception), bits)
    assert numpy.abs(ref_recs.astype(int) - recs.astype(int)).max() <= 1


def test_arithmetic_bits_equal_the_coder_on_random_symbols():
    from autoencoder_based_image_compression_tpu_torch.coding.compression import (
        compress_lossless_images,
    )

    probabilities = numpy.load(os.path.join(LEARNED, "statistics", "binary_probabilities_1.npy"))
    rng = numpy.random.default_rng(0)
    for scale in (0.3, 3.0, 40.0):
        symbols = numpy.round(rng.laplace(0.0, scale, size=(2, 4, 6, 128))).astype(numpy.int16)
        for exception in (-1, 7):
            numpy.testing.assert_array_equal(
                rate.image_bits(symbols.astype(numpy.int64), probabilities, exception),
                compress_lossless_images(symbols, probabilities, exception, verify=False))


@pytest.mark.parametrize("learn", [True, False])
def test_training_step_matches_the_port(learn):
    from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns

    generator = torch.Generator("cpu").manual_seed(5)
    weights = training.initial_weights(generator, learn, 1, "cpu")
    crops = synthetic.luminance_stack(2, 32, 32, generator, "cpu")
    state = training._program_state(weights, 0.5 if learn else 1.0, ladder=False)
    noises = [torch.rand((2, 2, 2, 128), generator=generator) - 0.5 for _ in range(2)]
    after = make_step_fns(10000.0, learn)["train_step"](state, crops, tuple(noises))
    ref = reference.State({k: v[0] for (k, v) in weights.items()}, 0.5 if learn else 1.0, learn)
    ref.step(crops, noises, 10000.0)
    for (name, value) in ref.params.items():
        # Adam turns the sign of a near-zero gradient into a whole step of
        # its rate: a few entries may sit 2 x 1e-4 apart, no more.
        gap = (after.params[name] - value).abs()
        assert float(gap.max()) <= 2.1 * reference.LR_ADAM
        assert float((gap > 1e-4 * value.abs() + 1e-6).to(torch.float64).mean()) <= 1e-4
    torch.testing.assert_close(after.density.parameters, ref.table, rtol=1e-5, atol=1e-6)
    assert int(after.density.nb_itvs_per_side) == ref.nb_itvs
    torch.testing.assert_close(after.bin_widths, ref.bin_widths)
    for (name, grad) in ref.first_gradient.items():
        # Summed in another order: within 1e-4 of the leaf's largest entry.
        torch.testing.assert_close(after.opt_eae.mu[name] / 0.1, grad, rtol=0.0,
                                   atol=1e-4 * float(grad.abs().max()))


def test_initial_table_matches_the_ports():
    from autoencoder_based_image_compression_tpu_torch.ops.density import init_density_table

    (table, live) = reference.initial_table(128, "cpu")
    port = init_density_table(128)
    torch.testing.assert_close(table, port.parameters, rtol=1e-6, atol=0.0)
    assert live == int(port.nb_itvs_per_side)
