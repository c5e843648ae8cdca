"""Finite-difference gradient checking.

Counterpart of the reference package's ``ops/gradcheck.py``. The
reference treats gradient checking as a first-class feature on the SVHN
side (``svhn/eae/EntropyAutoencoder.py:318-857`` runs finite-difference
comparisons inside its hand-derived backprop). Autograd replaces the
hand derivation, but the *check* still validates the differentiability
assumptions of the custom losses (piecewise-linear gathers, entropy
terms, the noise parametrisation) against central differences.

The analytic gradient is taken at the input's dtype (float32 for the
losses here), as the reference package does, and the central
differences in float64: ``fn`` is evaluated on float64 tensors, so that
the rounding of a float32 loss (a few ulps over ``2 * eps``, up to
1.5e-4 on the density loss, where PyTorch's float32 sums round
differently from XLA's) does not swamp the difference. The reference
package's tolerances then carry over with room to spare.
"""

import numpy
import torch


def finite_difference_grad(fn, x, eps=1e-4):
    """Central-difference gradient of a scalar function at x (numpy)."""
    x = numpy.asarray(x, dtype=numpy.float64)
    grad = numpy.zeros_like(x)
    flat = x.reshape(-1)
    grad_flat = grad.reshape(-1)
    for i in range(flat.size):
        original = flat[i]
        flat[i] = original + eps
        up = float(fn(x.reshape(x.shape)))
        flat[i] = original - eps
        down = float(fn(x.reshape(x.shape)))
        flat[i] = original
        grad_flat[i] = (up - down) / (2.0 * eps)
    return grad


def check_grad(fn, x, rtol=1e-3, atol=1e-5, eps=1e-4):
    """Compares the autograd gradient of ``fn`` (a scalar function of a
    tensor, which must also accept a float64 one) at ``x`` (numpy)
    against central differences.

    Returns ``(analytic, numeric)`` in float64; raises AssertionError on
    a mismatch. Intended for small inputs (finite differences take
    ``2 * x.size`` evaluations).
    """
    leaf = torch.tensor(numpy.asarray(x)).requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(fn(leaf), leaf)
    analytic = grad.detach().numpy().astype(numpy.float64)
    with torch.no_grad():
        numeric = finite_difference_grad(lambda v: fn(torch.from_numpy(v)), x, eps)
    numpy.testing.assert_allclose(analytic, numeric, rtol=rtol, atol=atol)
    return (analytic, numeric)
