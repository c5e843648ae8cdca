"""The GDN kernels and their gradients with a gamma that is not symmetric.

The EAE projects its gammas onto symmetric matrices after every step;
the scale hyperprior (``models/hyperprior.py``) learns gamma freely, so
the wrappers' ``[k][c]`` indexing (``pool_c = sum_k x_k^2 gamma[k][c]``)
and the ``gamma.T`` of ``GdnFunction`` / ``GdnStackedFunction``'s
backward are on its path. Here both backwards are held against autograd
through the plain versions with a random non-symmetric gamma on the CPU;
the ``cuda``-marked tests hold the kernels' forward and the gradient
through them against the same on the card. Imports no JAX, so that the
card's machine runs this file (``-m cuda --noconftest``).
"""

import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    GdnFunction,
    GdnStackedFunction,
    gdn_2d,
    gdn_2d_plain,
    gdn_stacked_2d,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32


def _case(rows, seed, models=None, dtype=torch.float32):
    """``(x, gamma, beta, upstream)``; gamma's two triangles drawn apart,
    so that it is far from symmetric."""
    generator = torch.Generator().manual_seed(seed)
    lead = () if models is None else (models,)
    x = 2.0 * torch.randn((rows,) + lead + (128,), generator=generator, dtype=dtype)
    gamma = 0.05 * torch.rand(lead + (128, 128), generator=generator, dtype=dtype)
    gamma = gamma * torch.triu(torch.ones(128, 128, dtype=dtype)) + 0.2 * gamma * torch.tril(
        torch.ones(128, 128, dtype=dtype), -1)
    beta = 0.5 + torch.rand(lead + (128,), generator=generator, dtype=dtype)
    upstream = torch.randn(x.shape, generator=generator, dtype=dtype)
    return (x, gamma, beta, upstream)


def _asymmetry(gamma):
    return float((gamma - gamma.transpose(-1, -2)).abs().max() / gamma.abs().max())


def _grads(fn, tensors, upstream):
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    return torch.autograd.grad(fn(*leaves), leaves, upstream)


def _stacked_plain(x, gamma, beta, inverse):
    return torch.stack([gdn_2d_plain(x[:, m], gamma[m], beta[m], inverse)
                        for m in range(x.shape[1])], dim=1)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_function_backward_with_an_asymmetric_gamma(inverse):
    (x, gamma, beta, upstream) = _case(96, 1 + int(inverse))
    assert _asymmetry(gamma) > 0.5
    got = _grads(lambda *a: gdn_2d(*a, inverse=inverse), (x, gamma, beta), upstream)
    expected = _grads(lambda *a: gdn_2d_plain(*a, inverse), (x, gamma, beta), upstream)
    # fp32 both ways; only the order of the sums differs.
    for (a, b) in zip(got, expected):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)
    # The transpose matters: a backward that took gamma for gamma.T is far off.
    wrong = _grads(lambda *a: gdn_2d_plain(*a, inverse),
                   (x, gamma.t().contiguous(), beta), upstream)
    assert float((wrong[0] - expected[0]).abs().max()) > 100 * float(
        (got[0] - expected[0]).abs().max())


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_stacked_function_backward_with_an_asymmetric_gamma(inverse):
    (x, gamma, beta, upstream) = _case(64, 3 + int(inverse), models=3)
    got = _grads(lambda *a: gdn_stacked_2d(*a, inverse=inverse), (x, gamma, beta), upstream)
    expected = _grads(lambda *a: _stacked_plain(*a, inverse), (x, gamma, beta), upstream)
    for (a, b) in zip(got, expected):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_gradcheck_float64_with_an_asymmetric_gamma(stacked, inverse):
    (x, gamma, beta, _) = _case(5, 7 + int(inverse), models=2 if stacked else None,
                                dtype=torch.float64)
    (x, gamma, beta) = (x[..., :4].contiguous(), gamma[..., :4, :4].contiguous(),
                        beta[..., :4].contiguous())
    function = GdnStackedFunction if stacked else GdnFunction
    leaves = [t.requires_grad_(True) for t in (x, gamma, beta)]
    assert torch.autograd.gradcheck(lambda *a: function.apply(*a, inverse), leaves, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    disable_tf32()  # the plain versions' matmuls in true fp32


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [131072, 8192, 1007])
def test_cuda_kernel_and_gradient_with_an_asymmetric_gamma(inverse, rows):
    _cuda()
    (x, gamma, beta, upstream) = [t.cuda() for t in _case(rows, 11 + int(inverse))]
    with torch.no_grad():
        out = gdn_2d(x, gamma, beta, inverse=inverse)
        expected = gdn_2d_plain(x, gamma, beta, inverse)
    torch.testing.assert_close(out, expected, rtol=2e-5, atol=1e-5)
    got = _grads(lambda *a: gdn_2d(*a, inverse=inverse), (x, gamma, beta), upstream)
    plain = _grads(lambda *a: gdn_2d_plain(*a, inverse), (x, gamma, beta), upstream)
    for (a, b) in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_stacked_kernel_and_gradient_with_an_asymmetric_gamma(inverse):
    _cuda()
    (x, gamma, beta, upstream) = [t.cuda() for t in _case(4096, 13 + int(inverse), models=3)]
    with torch.no_grad():
        out = gdn_stacked_2d(x, gamma, beta, inverse=inverse)
        expected = _stacked_plain(x, gamma, beta, inverse)
    torch.testing.assert_close(out, expected, rtol=2e-5, atol=1e-5)
    got = _grads(lambda *a: gdn_stacked_2d(*a, inverse=inverse), (x, gamma, beta), upstream)
    plain = _grads(lambda *a: _stacked_plain(*a, inverse), (x, gamma, beta), upstream)
    for (a, b) in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert gdn_kernel.LAUNCHES["gdn_f32_stacked"] + gdn_kernel.LAUNCHES["igdn_f32_stacked"] > 0
