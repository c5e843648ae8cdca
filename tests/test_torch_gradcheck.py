"""PyTorch port: the finite-difference gradient check (``ops/gradcheck.py``)
against the JAX package's, on the two losses ``tests/test_gradcheck_viz.py``
checks: the density fit's loss with respect to the table (the gather's
gradient) and the entropy with respect to the samples (the gradient the
reference injects by hand at the latent layer). Tolerance: the JAX
test's rtol 2e-2 / atol 1e-4 between autograd and central differences;
autograd's gradient against ``jax.grad``'s at rtol 1e-5 / atol 1e-7. The
port's central differences (taken in float64) sit within 1e-5 of its
analytic gradient, closer than JAX's (taken around a float32 function).
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.ops import density as jdens
from autoencoder_based_image_compression_tpu.ops import gradcheck as jgradcheck
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops import gradcheck

PPI = 4
MAX_ITVS = 8


def _density_losses():
    rng = numpy.random.default_rng(0)
    samples = rng.uniform(-3.0, 3.0, size=(1, 40)).astype(numpy.float32)
    table = jdens.init_density_table(1, PPI, MAX_ITVS, nb_itvs_init=4)
    jmask = jdens.active_mask(table.nb_itvs_per_side, PPI, MAX_ITVS)
    mask = dens.active_mask(torch.tensor(4), PPI, MAX_ITVS)

    def jax_loss(parameters):
        prob = jdens.approximate_probability(jnp.asarray(samples), parameters, PPI, MAX_ITVS)
        return jdens.loss_density_approximation(prob, parameters, jmask, PPI)

    def loss(parameters):
        prob = dens.approximate_probability(torch.from_numpy(samples), parameters, PPI,
                                            MAX_ITVS)
        return dens.loss_density_approximation(prob, parameters, mask, PPI)

    return (numpy.asarray(table.parameters), jax_loss, loss)


def _entropies():
    rng = numpy.random.default_rng(1)
    parameters = jdens.init_density_table(1, PPI, MAX_ITVS, nb_itvs_init=4).parameters
    samples0 = rng.uniform(-2.0, 2.0, size=(1, 12)).astype(numpy.float32)
    # Away from the grid knots, where the piecewise-linear pdf has a kink.
    samples0 = numpy.round(samples0 * PPI) / PPI + 0.11

    def jax_entropy(samples):
        prob = jdens.approximate_probability(jnp.asarray(samples), parameters, PPI, MAX_ITVS)
        return jdens.approximate_entropy(prob, jnp.ones((1,), jnp.float32))

    def entropy(samples):
        prob = dens.approximate_probability(samples, torch.from_numpy(numpy.asarray(parameters)),
                                            PPI, MAX_ITVS)
        return dens.approximate_entropy(prob, torch.ones((1,)))

    return (samples0, jax_entropy, entropy)


@pytest.mark.parametrize("case", [_density_losses, _entropies], ids=["density_loss", "entropy"])
def test_check_grad_matches_jax(case):
    (x, jax_fn, fn) = case()
    (analytic, numeric) = gradcheck.check_grad(fn, x, rtol=2e-2, atol=1e-4)
    (jax_analytic, jax_numeric) = jgradcheck.check_grad(jax_fn, x, rtol=2e-2, atol=1e-4)
    assert analytic.dtype == numpy.float64 and analytic.shape == x.shape
    numpy.testing.assert_allclose(analytic, jax_analytic, rtol=1e-5, atol=1e-7)
    # The port's differences are taken in float64, JAX's around a float32
    # function: the port's sit closer to the analytic gradient.
    port_gap = numpy.abs(numeric - analytic).max()
    assert port_gap <= numpy.abs(jax_numeric - jax_analytic).max() and port_gap <= 1e-5


def test_finite_difference_grad_matches_jax_on_a_smooth_function():
    x = numpy.linspace(-1.0, 1.0, 7)

    def fn(v):
        return numpy.sum(numpy.sin(v) * v ** 2)

    got = gradcheck.finite_difference_grad(fn, x)
    numpy.testing.assert_array_equal(got, jgradcheck.finite_difference_grad(fn, x))
    numpy.testing.assert_allclose(got, numpy.cos(x) * x ** 2 + 2 * x * numpy.sin(x),
                                  rtol=1e-6, atol=1e-7)


def test_check_grad_catches_a_wrong_gradient():
    class WrongSquare(torch.autograd.Function):
        """sum(x^2) with the gradient 4x instead of 2x."""

        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.sum(x ** 2)

        @staticmethod
        def backward(ctx, grad):
            return grad * 4.0 * ctx.saved_tensors[0]

    x = numpy.array([0.3, -0.7, 1.1], dtype=numpy.float32)
    with pytest.raises(AssertionError):
        gradcheck.check_grad(WrongSquare.apply, x)
    (analytic, _) = gradcheck.check_grad(lambda v: torch.sum(v ** 2), x, rtol=1e-3, atol=1e-4)
    numpy.testing.assert_allclose(analytic, 2 * x, rtol=1e-6)
