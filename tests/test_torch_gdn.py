"""PyTorch port: the GDN kernels' plain versions against the JAX package's
Pallas kernels (run in interpret mode, as the JAX package's own tests
run them), plus the wrappers' contracts.

On the CPU the wrappers run the plain versions; the tests marked
``cuda`` hold the CUDA kernels against them on a card.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.ops.gdn import gdn_lowp as jax_gdn_lowp
from autoencoder_based_image_compression_tpu.ops.pallas.gdn_kernel import (
    gdn_pallas_2d,
    gdn_quantize_pallas_2d,
)
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_2d,
    gdn_nhwc,
    gdn_quantize_2d,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000",
                       "params_trained.npz")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000",
                     "params_trained.npz")
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 at the bottom of a binade


def _inputs(rows, seed, trained=None):
    """x (rows, 128) and gamma/beta: random, or a trained pair."""
    rng = numpy.random.default_rng(seed)
    x = rng.normal(size=(rows, 128)).astype(numpy.float32)
    if trained is None:
        gamma = (numpy.abs(rng.normal(size=(128, 128))) * 0.01).astype(numpy.float32)
        beta = numpy.ones(128, numpy.float32)
    else:
        (path, index) = trained
        with numpy.load(path) as data:
            gamma = data[f"param:gamma_{index}"].astype(numpy.float32)
            beta = data[f"param:beta_{index}"].astype(numpy.float32)
        x *= 4.0  # the trained GDNs see activations of this order
    return (x, gamma, beta)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [(300, None), (77, None), (300, (LEARNED, 1)), (77, (LEARNED, 6))]


@pytest.fixture(autouse=True)
def true_fp32_matmul():
    """The plain versions' pools in true fp32 while a test runs, whatever
    another test of the same process left set: PyTorch's fp32 matmul
    precision is process-wide, and at "medium" (or with oneDNN's fp32
    matmuls in bf16) a CPU with AMX-BF16 rounds the pool's operands to
    bf16, some 5e-4 off. Restored afterwards."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.mkldnn.matmul.fp32_precision)
    torch.set_float32_matmul_precision("highest")
    torch.backends.mkldnn.matmul.fp32_precision = "ieee"
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def _gdn_float64(x, gamma, beta, inverse):
    """The oracle of both sides: GDN / IGDN in float64 numpy."""
    x = x.astype(numpy.float64)
    pool = numpy.square(x) @ gamma.astype(numpy.float64) + beta.astype(numpy.float64)
    return x * (numpy.sqrt(pool) if inverse else 1.0 / numpy.sqrt(pool))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,trained", CASES)
def test_gdn_fp32_matches_pallas(rows, trained, inverse):
    (x, gamma, beta) = _inputs(rows, rows + int(inverse), trained)
    expected = numpy.asarray(gdn_pallas_2d(jnp.asarray(x), jnp.asarray(gamma),
                                           jnp.asarray(beta), inverse=inverse,
                                           interpret=True))
    got = gdn_2d(*_t(x, gamma, beta), inverse=inverse)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 128)
    # Each side against float64 first, so that a failure names the side
    # that left fp32 (both sit within 3e-7 of it here).
    oracle = _gdn_float64(x, gamma, beta, inverse)
    for (side, values) in (("the JAX package's Pallas kernel", expected),
                           ("the port's plain version", got.numpy())):
        numpy.testing.assert_allclose(values, oracle, rtol=1e-5, atol=1e-6,
                                      err_msg=f"{side} against float64")
    # fp32 on both sides; only the order of the 128-term pool sum differs.
    numpy.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows,trained", CASES)
def test_gdn_bf16_matches_pallas_and_gdn_lowp(rows, trained, inverse):
    (x, gamma, beta) = _inputs(rows, 10 + rows + int(inverse), trained)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    got = gdn_2d(torch.from_numpy(x).to(torch.bfloat16), *_t(gamma, beta),
                 inverse=inverse)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    for expected in (gdn_pallas_2d(x16, jnp.asarray(gamma), jnp.asarray(beta),
                                   inverse=inverse, interpret=True),
                     jax_gdn_lowp(x16, jnp.asarray(gamma), jnp.asarray(beta),
                                  inverse=inverse)):
        expected = numpy.asarray(expected.astype(jnp.float32))
        # Same bf16-rounded operands and fp32 pool on both sides; the
        # pool's summation order can move the final bf16 rounding by at
        # most one ulp.
        assert numpy.all(numpy.abs(got - expected) <= BF16_ULP * numpy.abs(expected))


def _quantize_case(rows, seed):
    (x, gamma, beta) = _inputs(rows, seed, (FIXED, 3))
    rng = numpy.random.default_rng(seed + 100)
    bin_widths = rng.uniform(0.5, 1.5, 128).astype(numpy.float32)
    return (x, gamma, beta, bin_widths)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [300, 77])
def test_gdn_quantize_matches_pallas(rows, inverse):
    (x, gamma, beta, bin_widths) = _quantize_case(rows, rows + 20 * int(inverse))
    expected = numpy.asarray(gdn_quantize_pallas_2d(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(bin_widths), inverse=inverse, interpret=True))
    got = gdn_quantize_2d(*_t(x, gamma, beta, bin_widths), inverse=inverse).numpy()
    flips = got != expected
    print("tie_flips", int(flips.sum()))
    # Identical except where gdn(x)/bw sits on a rounding tie, where the
    # pool's summation order may decide; a flip moves exactly one bin.
    assert flips.mean() <= 1e-4
    numpy.testing.assert_allclose(numpy.abs(got - expected)[flips],
                                  numpy.broadcast_to(bin_widths, got.shape)[flips],
                                  rtol=1e-6)


def test_gdn_quantize_rounds_half_to_even():
    # gamma = 0, beta = 1: the pool is exactly 1, so gdn(x) == x and x
    # sits exactly on the .5 ties of power-of-two bin widths.
    ties = numpy.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5], numpy.float32)
    bin_widths = numpy.where(numpy.arange(128) % 2 == 0, 1.0, 0.5).astype(numpy.float32)
    x = (ties[:, None] * bin_widths[None, :]).astype(numpy.float32)
    gamma = numpy.zeros((128, 128), numpy.float32)
    beta = numpy.ones(128, numpy.float32)
    expected = numpy.asarray(gdn_quantize_pallas_2d(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(bin_widths), interpret=True))
    got = gdn_quantize_2d(*_t(x, gamma, beta, bin_widths)).numpy()
    even = numpy.array([0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0, -4.0], numpy.float32)
    numpy.testing.assert_array_equal(got, even[:, None] * bin_widths[None, :])
    numpy.testing.assert_array_equal(got, expected)


def test_gdn_nhwc_matches_2d():
    (x, gamma, beta) = _inputs(2 * 3 * 5, 7)
    x_nhwc = torch.from_numpy(x).reshape(2, 3, 5, 128)
    for inverse in (False, True):
        got = gdn_nhwc(x_nhwc, *_t(gamma, beta), inverse=inverse)
        assert tuple(got.shape) == (2, 3, 5, 128)
        torch.testing.assert_close(
            got.reshape(-1, 128), gdn_2d(torch.from_numpy(x), *_t(gamma, beta),
                                         inverse=inverse), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["channels", "dtype", "gamma", "bin_widths"])
def test_wrappers_reject_bad_operands(bad):
    (x, gamma, beta) = _t(*_inputs(8, 3))
    bin_widths = torch.ones(128)
    if bad == "channels":
        with pytest.raises(ValueError):
            gdn_2d(torch.zeros(8, 64), gamma, beta)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            gdn_2d(x.to(torch.float64), gamma, beta)
        with pytest.raises(TypeError):
            gdn_quantize_2d(x.to(torch.bfloat16), gamma, beta, bin_widths)
    elif bad == "gamma":
        with pytest.raises(ValueError):
            gdn_2d(x, gamma[:64], beta)
    else:
        with pytest.raises(ValueError):
            gdn_quantize_2d(x, gamma, beta, bin_widths[:64])


def test_cpu_tensors_never_launch():
    gdn_kernel.reset_launch_counts()
    (x, gamma, beta, bin_widths) = _t(*_quantize_case(16, 5))
    gdn_2d(x, gamma, beta)
    gdn_quantize_2d(x, gamma, beta, bin_widths)
    assert sum(gdn_kernel.LAUNCHES.values()) == 0


@pytest.mark.parametrize("rows,height", [(98304, 128), (24576, 64), (6144, 64),
                                         (98304 + 37, 128), (1007, 32), (1, 32)])
def test_tile_rows_for_the_main_path_shapes(rows, height):
    # 4 x 512 x 768 at H/4, H/8, H/16 on 132 SMs: 768 tiles of 128 rows
    # (6 to the busiest SM), 384 of 64 (3), 96 of 64 (1, as few rows as 2
    # of 32 and faster on the card).
    assert gdn_kernel.tile_rows(rows) == height
    assert gdn_kernel.tile_rows(rows, sms=132) == height
    assert height in gdn_kernel.TILE_ROWS


# A small ragged row count, and the H/4 shape of a 4 x 512 x 768 batch
# plus a ragged tail.
CUDA_ROWS = [1000 + 7, 98304 + 37]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", CUDA_ROWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_gdn_kernel_matches_plain(dtype, inverse, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; chip_smoke.py runs this check on the card)")
    (x, gamma, beta) = [t.cuda() for t in _t(*_inputs(rows, 3, (LEARNED, 1)))]
    x = x.to(getattr(torch, dtype))
    before = dict(gdn_kernel.LAUNCHES)
    got = gdn_2d(x, gamma, beta, inverse=inverse)
    torch.cuda.synchronize()
    assert gdn_kernel.LAUNCHES != before
    expected = gdn_kernel.gdn_2d_plain(x, gamma, beta, inverse)
    if dtype == "float32":
        torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
    else:
        diff = (got.float() - expected.float()).abs()
        assert bool((diff <= BF16_ULP * expected.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", CUDA_ROWS)
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_gdn_quantize_kernel_matches_plain(inverse, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; chip_smoke.py runs this check on the card)")
    (x, gamma, beta, bin_widths) = [t.cuda() for t in _t(*_quantize_case(rows, 4))]
    got = gdn_quantize_2d(x, gamma, beta, bin_widths, inverse=inverse)
    expected = gdn_kernel.gdn_quantize_2d_plain(x, gamma, beta, bin_widths, inverse)
    assert float((got != expected).float().mean()) <= 1e-4
