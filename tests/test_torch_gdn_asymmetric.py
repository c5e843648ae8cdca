"""The GDN kernels and their gradients with a gamma that is not symmetric.

The EAE projects its gammas onto symmetric matrices after every step;
the scale hyperprior (``models/hyperprior.py``) learns gamma freely, so
the wrappers' ``[k][c]`` indexing (``pool_c = sum_k x_k^2 gamma[k][c]``)
and the ``gamma.T`` of the backward (``gdn_backward``, shared by
``GdnFunction`` and ``GdnStackedFunction``) are on its path. Here both
functions' backwards, and the plain twin ``gdn_backward_plain`` for every
subset of the gradients, are held against autograd through the plain
versions on the CPU, with a random non-symmetric gamma and a symmetric
one; the ``cuda``-marked tests hold the kernels' forward, the gradient
kernel at every training site's rows (and a ragged count) and its
launches against the same on the card. Imports no JAX, so that the
card's machine runs this file (``-m cuda --noconftest``).
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import itertools

import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    GdnFunction,
    GdnStackedFunction,
    gdn_2d,
    gdn_2d_plain,
    gdn_backward,
    gdn_backward_plain,
    gdn_stacked_2d,
    gdn_stacked_2d_plain,
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


# Each non-empty subset of (grad_x, grad_gamma, grad_beta).
NEEDS = [needs for needs in itertools.product((False, True), repeat=3) if any(needs)]


def _needs_id(needs):
    return "+".join(name for (name, need) in zip(("x", "gamma", "beta"), needs) if need)


@pytest.mark.parametrize("needs", NEEDS, ids=_needs_id)
@pytest.mark.parametrize("models", [None, 3], ids=["single", "stacked"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asymmetric", "symmetric"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_twin_equals_autograd_through_the_plain_versions(inverse, symmetric, models,
                                                                   needs):
    """``gdn_backward_plain``, the one copy of the formulas, against
    autograd through ``gdn_2d_plain`` (one model, as a stack of one) and
    ``gdn_stacked_2d_plain``; what ``needs`` leaves out comes back None.
    ``gdn_backward`` on CPU tensors is the twin itself."""
    (x, gamma, beta, upstream) = _case(48, 21 + int(inverse) + 2 * int(symmetric), models)
    if symmetric:
        gamma = 0.5 * (gamma + gamma.transpose(-1, -2))
    else:
        assert _asymmetry(gamma) > 0.5
    plain = gdn_2d_plain if models is None else gdn_stacked_2d_plain
    leaves = [t.clone().requires_grad_(need) for (t, need) in zip((x, gamma, beta), needs)]
    expected = iter(torch.autograd.grad(plain(*leaves, inverse), [
        leaf for (leaf, need) in zip(leaves, needs) if need], upstream))
    stack = (lambda t, axis: t) if models is not None else (lambda t, axis: t.unsqueeze(axis))
    operands = (stack(x, 1), stack(gamma, 0), stack(beta, 0), stack(upstream, 1), inverse,
                needs)
    got = gdn_backward_plain(*operands)
    for (grad, via_wrapper, need, axis) in zip(got, gdn_backward(*operands), needs, (1, 0, 0)):
        assert (grad is None) == (not need) and (via_wrapper is None) == (not need)
        if need:
            assert torch.equal(grad, via_wrapper)
            grad = grad if models is not None else grad.squeeze(axis)
            # fp32 both ways; only the order of the sums differs.
            torch.testing.assert_close(grad, next(expected), rtol=1e-4, atol=2e-5)


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


# The training sites' rows: (rows a model, models, gamma symmetric). The
# EAE at a batch of 10 crops of 256 x 256 (one model and the seven-model
# ladder), the scale hyperprior at 8 (gamma learned freely), and ragged
# counts.
TRAINING_SITES = [(40960, 1, True), (10240, 1, True), (2560, 1, True), (40960, 7, True),
                  (10240, 7, True), (2560, 7, True), (131072, 1, False), (32768, 1, False),
                  (8192, 1, False), (2560 + 37, 1, False), (10240 + 37, 7, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
@pytest.mark.parametrize("rows,models,symmetric", TRAINING_SITES)
def test_cuda_backward_kernel_at_the_training_sites(rows, models, symmetric, inverse):
    """The gradient kernel through the autograd functions against its twin
    (each gradient within 1e-4 of its largest entry), its tile pass and its
    reduction counted once a call at its rows, where they launch (a direct
    call of ``gdn_backward`` counts too); two calls give the same bits."""
    _cuda()
    (x, gamma, beta, upstream) = [t.cuda() for t in _case(rows, 31 + int(inverse),
                                                          None if models == 1 else models)]
    if symmetric:
        gamma = 0.5 * (gamma + gamma.transpose(-1, -2))
    stacked = models > 1
    variant = ("igdn_f32" if inverse else "gdn_f32") + (
        "_stacked_backward" if stacked else "_backward")
    key = (variant, (rows, models) if stacked else rows)
    reduce_key = ("gdn_backward_reduce", (rows, models))
    function = gdn_stacked_2d if stacked else gdn_2d

    def counts():
        return (gdn_kernel.LAUNCHES[variant], gdn_kernel.LAUNCH_ROWS[key],
                gdn_kernel.LAUNCHES["gdn_backward_reduce"], gdn_kernel.LAUNCH_ROWS[reduce_key])

    before = counts()
    got = _grads(lambda *a: function(*a, inverse=inverse), (x, gamma, beta), upstream)
    torch.cuda.synchronize()
    assert counts() == tuple(n + 1 for n in before)
    operands = ((x, gamma, beta, upstream) if stacked
                else (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                      upstream.unsqueeze(1)))
    plain = gdn_backward_plain(*operands, inverse)
    if not stacked:
        plain = (plain[0][:, 0], plain[1][0], plain[2][0])
    for (a, b) in zip(got, plain):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    first = gdn_backward(*operands, inverse, stacked=stacked)
    again = gdn_backward(*operands, inverse, stacked=stacked)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for (a, b) in zip(first, again))
    assert counts() == tuple(n + 3 for n in before)


@pytest.mark.cuda
def test_cuda_backward_refuses_a_grad_out_it_cannot_read():
    _cuda()
    (x, gamma, beta, upstream) = [t.cuda() for t in _case(64, 41, 2)]
    with pytest.raises(ValueError, match="C-contiguous"):
        gdn_backward(x, gamma, beta, upstream.transpose(0, 1).contiguous().transpose(0, 1),
                     False)
    with pytest.raises(ValueError, match="grad_out of shape"):
        gdn_backward(x, gamma, beta, upstream[:32], False)


@pytest.mark.cuda
def test_cuda_backward_launches_of_a_hyperprior_step():
    """One eager step of the scale hyperprior: every one of its six GDN
    sites' backward goes through the gradient kernel, once, at its rows."""
    _cuda()
    from autoencoder_based_image_compression_tpu_torch.train import hyperprior

    generator = torch.Generator("cuda").manual_seed(51)
    state = hyperprior.init_hyperprior_state(generator, "cuda")
    batch = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8, device="cuda",
                          generator=generator)
    fns = hyperprior.make_hyperprior_step_fns()
    gdn_kernel.reset_launch_counts()
    fns["train_step"](state, batch, generator)
    torch.cuda.synchronize()
    assert gdn_kernel.LAUNCHES["gdn_backward_reduce"] == 6
    for variant in ("gdn_f32_backward", "igdn_f32_backward"):
        assert gdn_kernel.LAUNCHES[variant] == 3
        assert {rows: n for ((name, rows), n) in gdn_kernel.LAUNCH_ROWS.items()
                if name == variant} == {131072: 1, 32768: 1, 8192: 1}
