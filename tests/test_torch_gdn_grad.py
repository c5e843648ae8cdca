"""PyTorch port: the differentiable GDN kernel wrapper.

``GdnFunction`` runs the kernel's forward (its plain version on the CPU)
and ``gdn_backward``: the gradient kernel on the card, its plain twin
``gdn_backward_plain`` on the CPU. The backward is held against
``torch.autograd.gradcheck`` in float64 and against ``jax.grad`` of the
JAX package's ``ops/gdn.py`` in float32; the routing of ``gdn_2d``
(through ``GdnFunction`` whenever an operand requires grad, never a
detached result) and its refusals, the backward's among them, are
checked here on the CPU and on the card by ``chip_smoke.py`` and
``tests/test_torch_gdn_asymmetric.py``.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.ops.gdn import gdn as jax_gdn
from autoencoder_based_image_compression_tpu.ops.gdn import inverse_gdn as jax_inverse_gdn
from autoencoder_based_image_compression_tpu_torch.ops import gdn as tgdn
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    GdnFunction,
    gdn_2d,
    gdn_nhwc,
    gdn_quantize_2d,
)


def _inputs(rows, channels, seed, dtype=numpy.float32):
    rng = numpy.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((rows, channels))).astype(dtype)
    raw = rng.uniform(2e-5, 0.05, (channels, channels))
    gamma = (0.5 * (raw + raw.T)).astype(dtype)
    beta = rng.uniform(0.5, 1.5, channels).astype(dtype)
    upstream = rng.standard_normal((rows, channels)).astype(dtype)
    return (x, gamma, beta, upstream)


@pytest.mark.parametrize("inverse", [False, True])
def test_gradcheck_float64(inverse):
    (x, gamma, beta, _) = [torch.from_numpy(a).requires_grad_(True)
                           for a in _inputs(5, 4, int(inverse), numpy.float64)]
    assert torch.autograd.gradcheck(
        lambda x, gamma, beta: GdnFunction.apply(x, gamma, beta, inverse),
        (x, gamma, beta), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [300, 77])
def test_gradients_match_jax_grad(rows, inverse):
    (x, gamma, beta, upstream) = _inputs(rows, 128, rows + int(inverse))
    fn_j = jax_inverse_gdn if inverse else jax_gdn
    grads_j = jax.grad(lambda x, gamma, beta: jnp.sum(fn_j(x, gamma, beta) * upstream),
                       argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                                          jnp.asarray(beta))
    (xt, gt, bt) = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    out = gdn_2d(xt, gt, bt, inverse=inverse)
    assert out.requires_grad and isinstance(out.grad_fn, GdnFunction._backward_cls)
    grads_t = torch.autograd.grad(out, (xt, gt, bt), torch.from_numpy(upstream))
    # float32 on both sides; grad_x contracts 128 terms, grad_gamma and
    # grad_beta sum over the rows (up to 300): order of summation only.
    for (name, got, expected, atol) in zip(("x", "gamma", "beta"), grads_t, grads_j,
                                           (1e-6, 2e-5, 2e-5)):
        numpy.testing.assert_allclose(got.numpy(), numpy.asarray(expected), rtol=1e-4,
                                      atol=atol, err_msg=f"grad_{name}")


@pytest.mark.parametrize("inverse", [False, True])
def test_backward_matches_autograd_through_plain(inverse):
    (x, gamma, beta, upstream) = _inputs(64, 128, 5 + int(inverse))
    plain = tgdn.inverse_gdn if inverse else tgdn.gdn
    grads = []
    for fn in (lambda *a: gdn_2d(*a, inverse=inverse), plain):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(upstream)))
    for (got, expected) in zip(*grads):
        torch.testing.assert_close(got, expected, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("which", ["x", "gamma", "beta"])
def test_only_the_needed_gradients_are_computed(which):
    (x, gamma, beta, _) = [torch.from_numpy(a) for a in _inputs(16, 128, 9)]
    leaves = {"x": x, "gamma": gamma, "beta": beta}
    leaves[which].requires_grad_(True)
    out = gdn_2d(leaves["x"], leaves["gamma"], leaves["beta"])
    assert out.requires_grad
    out.sum().backward()
    for (name, leaf) in leaves.items():
        assert (leaf.grad is not None) == (name == which)


def test_no_grad_needed_means_no_autograd_node():
    (x, gamma, beta, _) = [torch.from_numpy(a) for a in _inputs(16, 128, 10)]
    assert not gdn_2d(x, gamma, beta).requires_grad
    x.requires_grad_(True)
    with torch.no_grad():
        assert not gdn_2d(x, gamma, beta).requires_grad
    # Through the NHWC wrapper the gradient reaches a 4-D input.
    x4 = x.detach().reshape(2, 2, 4, 128).requires_grad_(True)
    gdn_nhwc(x4, gamma, beta, inverse=True).sum().backward()
    assert x4.grad is not None and x4.grad.shape == x4.shape


def test_cpu_tensors_never_launch_with_grad():
    gdn_kernel.reset_launch_counts()
    (x, gamma, beta, _) = [torch.from_numpy(a).requires_grad_(True)
                           for a in _inputs(16, 128, 11)]
    gdn_2d(x, gamma, beta).sum().backward()
    assert sum(gdn_kernel.LAUNCHES.values()) == 0


@pytest.mark.parametrize("fault", ["transposed", "expanded", "fewer rows", "other models"])
def test_the_backward_refuses_a_grad_out_it_cannot_read(fault):
    """``gdn_backward`` (the one backward of both autograd functions, the
    gradient kernel's wrapper for a CUDA tensor) checks ``grad_out`` on
    every device before it dispatches: ``x``'s shape, C-contiguous. The
    autograd functions hand it a contiguous copy of what autograd gives
    (``out.sum()``'s gradient is an expanded tensor), so they never meet
    the refusal."""
    (x, gamma, beta, upstream) = [torch.from_numpy(a) for a in _inputs(16, 128, 15)]
    (x, gamma, beta, upstream) = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                                  upstream.unsqueeze(1))
    grad_out = {"transposed": upstream.transpose(0, 2).contiguous().transpose(0, 2),
                "expanded": torch.ones(1, 1, 1).expand(x.shape),
                "fewer rows": upstream[:8],
                "other models": upstream.expand(16, 2, 128).contiguous()}[fault]
    match = "C-contiguous" if fault in ("transposed", "expanded") else "grad_out of shape"
    with pytest.raises(ValueError, match=match):
        gdn_kernel.gdn_backward(x, gamma, beta, grad_out, False)
    got = gdn_kernel.gdn_backward(x, gamma, beta, upstream, False)
    assert all(g is not None for g in got)


def test_a_single_models_backward_refuses_a_stack():
    """``stacked=False`` (the backward of ``GdnFunction``, counted under the
    single-model variant) takes one model, on every device."""
    (x, gamma, beta, upstream) = [torch.from_numpy(a) for a in _inputs(16, 128, 16)]
    stack = [t.unsqueeze(0).expand(2, *t.shape).contiguous() for t in (gamma, beta)]
    (x, upstream) = [t.unsqueeze(1).expand(16, 2, 128).contiguous() for t in (x, upstream)]
    with pytest.raises(ValueError, match="single model"):
        gdn_kernel.gdn_backward(x, *stack, upstream, False, stacked=False)
    got = gdn_kernel.gdn_backward(x[:, :1].contiguous(), stack[0][:1], stack[1][:1],
                                  upstream[:, :1].contiguous(), False, stacked=False)
    assert all(g is not None for g in got)


@pytest.mark.parametrize("which", ["x", "gamma", "beta"])
def test_bf16_with_grad_raises(which):
    (x, gamma, beta, _) = [torch.from_numpy(a) for a in _inputs(16, 128, 12)]
    leaves = {"x": x.to(torch.bfloat16), "gamma": gamma, "beta": beta}
    leaves[which].requires_grad_(True)
    with pytest.raises(TypeError, match="fp32 only"):
        gdn_2d(leaves["x"], leaves["gamma"], leaves["beta"])
    with torch.no_grad():  # nothing to differentiate: served as before
        assert gdn_2d(leaves["x"], leaves["gamma"], leaves["beta"]).dtype == torch.bfloat16


@pytest.mark.parametrize("which", ["x", "gamma", "beta", "bin_widths"])
def test_fused_quantiser_with_grad_raises(which):
    (x, gamma, beta, _) = [torch.from_numpy(a) for a in _inputs(16, 128, 13)]
    leaves = {"x": x, "gamma": gamma, "beta": beta, "bin_widths": torch.ones(128)}
    leaves[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        gdn_quantize_2d(*leaves.values())
    with torch.no_grad():
        assert not gdn_quantize_2d(*leaves.values()).requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_gradient_through_the_kernel(inverse):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; chip_smoke.py runs this check on the card)")
    (x, gamma, beta, upstream) = _inputs(1007, 128, 14)
    grads = []
    for fn in (lambda *a: gdn_2d(*a, inverse=inverse),
               lambda *a: gdn_kernel.gdn_2d_plain(*a, inverse)):
        leaves = [torch.from_numpy(a).cuda().requires_grad_(True) for a in (x, gamma, beta)]
        out = fn(*leaves)
        assert out.requires_grad
        grads.append(torch.autograd.grad(out, leaves, torch.from_numpy(upstream).cuda()))
    for (got, expected) in zip(*grads):
        torch.testing.assert_close(got, expected, rtol=1e-4, atol=1e-4)
