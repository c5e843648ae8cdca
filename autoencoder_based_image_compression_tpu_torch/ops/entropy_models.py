"""The entropy models of Ballé et al.'s scale hyperprior, and its GDN
parameterisation.

Ballé, Minnen, Singh, Hwang, Johnston, *Variational image compression
with a scale hyperprior*, ICLR 2018 (arXiv:1802.01436), with the
arithmetic of tensorflow-compression's ``EntropyBottleneck``,
``GaussianConditional`` and ``GDN``:

- **Factorized density** of the hyper-latents ``z`` (the paper's
  Appendix 6.1): per channel, a cumulative ``c`` made of ``K + 1``
  layers over the filters ``(3, 3, 3)``: ``softplus(H) @ x + b``, and
  after each but the last, ``x + tanh(a) * tanh(x)``. The likelihood of
  ``z~`` is ``c(z~ + 1/2) - c(z~ - 1/2)``, each side a sigmoid of the
  logits, taken with the sign trick (both sides on the tail where the
  sigmoid does not saturate). Initialised for the scale 10.
- **Gaussian conditional** of the latents ``y`` given ``sigma`` (and,
  for Minnen et al.'s mean-scale model, a mean ``mu``; zero without it):
  ``Phi((1/2 - |y~ - mu|) / sigma) - Phi((-1/2 - |y~ - mu|) / sigma)``,
  which is ``Phi((y~ - mu + 1/2) / sigma) - Phi((y~ - mu - 1/2) / sigma)``
  taken on the lower tail, with ``sigma`` lower-bounded at 0.11.
- Both likelihoods are lower-bounded at 1e-9.
- **GDN parameters**: the nonnegative reparameterisation. The stored
  variables are ``sqrt(beta + p)`` and ``sqrt(gamma + p)``, the pedestal
  ``p = 2^-36`` (the square of the reparameterisation offset 2^-18);
  the effective ``beta = max(v, sqrt(1e-6 + p))^2 - p`` (at least 1e-6)
  and ``gamma = max(v, 2^-18)^2 - p`` (at least 0). Initial ``beta = 1``,
  ``gamma = 0.1 I``. The learned ``gamma`` is indexed ``[c][k]`` (the
  paper's ``gamma_ck``: map ``k``'s square in map ``c``'s pool) and is
  not symmetric.

Every lower bound is :func:`lower_bound`: the maximum forward, and a
gradient that passes where the input is at or above the bound or where
it pushes the input up (tensorflow-compression's ``identity_if_towards``).
"""

import math

import torch
import torch.nn.functional as F

FILTERS = (3, 3, 3)
INIT_SCALE = 10.0
SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9
REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
GAMMA_INIT = 0.1


class _LowerBound(torch.autograd.Function):
    """``max(x, bound)``; the gradient passes where ``x >= bound`` or where
    it is negative (a descent step would raise ``x``)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        passes = (x >= ctx.bound) | (grad < 0)
        return (grad * passes, None)


def lower_bound(x, bound):
    """``x`` bounded below by the number ``bound`` (module docstring)."""
    return _LowerBound.apply(x, bound)


# --- GDN parameters ----------------------------------------------------------

def gdn_beta(raw):
    """The effective GDN ``beta`` of its stored variable: at least 1e-6."""
    return torch.square(lower_bound(raw, math.sqrt(BETA_MIN + PEDESTAL))) - PEDESTAL


def gdn_gamma(raw):
    """The effective GDN ``gamma``, indexed ``[c][k]``, of its stored
    variable: at least 0."""
    return torch.square(lower_bound(raw, REPARAM_OFFSET)) - PEDESTAL


def init_gdn(channels, device):
    """``(beta_var, gamma_var)``: the stored variables of ``beta = 1`` and
    ``gamma = 0.1 I``."""
    beta = torch.sqrt(torch.ones((channels,), device=device) + PEDESTAL)
    gamma = torch.sqrt(GAMMA_INIT * torch.eye(channels, device=device) + PEDESTAL)
    return (beta, gamma)


# --- factorized density ------------------------------------------------------

def density_shapes(channels, filters=FILTERS):
    """``{name: shape}`` of the factorized density's parameters:
    ``matrix_i`` ``(C, f_{i+1}, f_i)``, ``bias_i`` ``(C, f_{i+1}, 1)`` for
    each of the ``K + 1`` layers and ``factor_i`` ``(C, f_{i+1}, 1)`` for
    each but the last, ``f = (1, *filters, 1)``."""
    widths = (1,) + tuple(filters) + (1,)
    shapes = {}
    for i in range(len(filters) + 1):
        shapes[f"matrix_{i}"] = (channels, widths[i + 1], widths[i])
        shapes[f"bias_{i}"] = (channels, widths[i + 1], 1)
        if i < len(filters):
            shapes[f"factor_{i}"] = (channels, widths[i + 1], 1)
    return shapes


def init_density(channels, generator, filters=FILTERS, init_scale=INIT_SCALE):
    """The factorized density's initial parameters, on ``generator``'s
    device: each matrix ``log(expm1(1 / scale / f_{i+1}))`` everywhere
    (``scale = init_scale^(1 / (K + 1))``), biases ``U(-1/2, 1/2)``,
    factors 0."""
    device = generator.device
    widths = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    params = {}
    for (name, shape) in density_shapes(channels, filters).items():
        layer = int(name.rsplit("_", 1)[1])
        if name.startswith("matrix"):
            value = math.log(math.expm1(1.0 / scale / widths[layer + 1]))
            params[name] = torch.full(shape, value, device=device)
        elif name.startswith("bias"):
            params[name] = torch.rand(shape, generator=generator, device=device) - 0.5
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def _logits_cumulative(params, samples, nb_layers):
    """The cumulative's logits at ``samples`` ``(C, 1, n)``: ``(C, 1, n)``."""
    logits = samples
    for i in range(nb_layers):
        logits = torch.matmul(F.softplus(params[f"matrix_{i}"]), logits) + params[f"bias_{i}"]
        if i < nb_layers - 1:
            logits = logits + torch.tanh(params[f"factor_{i}"]) * torch.tanh(logits)
    return logits


def factorized_likelihood(params, z_nhwc):
    """The factorized density's likelihood of each element of ``z_nhwc``
    ``(B, h, w, C)``, the same shape, at least 1e-9. ``params`` holds the
    density's parameters under the names of :func:`density_shapes`."""
    channels = z_nhwc.shape[-1]
    nb_layers = sum(name.startswith("matrix") for name in params)
    samples = z_nhwc.reshape(-1, channels).t().unsqueeze(1)  # (C, 1, n)
    n = samples.shape[-1]
    # Both sides of every interval through the layers at once.
    logits = _logits_cumulative(params, torch.cat([samples - 0.5, samples + 0.5], dim=-1),
                                nb_layers)
    (lower, upper) = (logits[..., :n], logits[..., n:])
    sign = -torch.sign(lower + upper).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    likelihood = lower_bound(likelihood, LIKELIHOOD_BOUND)
    return likelihood.squeeze(1).t().reshape(z_nhwc.shape)


# --- Gaussian conditional ----------------------------------------------------

def _standard_cumulative(x):
    """``Phi(x)`` of the unit Gaussian, through ``erfc`` (exact in the
    lower tail)."""
    return 0.5 * torch.special.erfc(-x * (2.0 ** -0.5))


def gaussian_likelihood(y, sigma, mean=None):
    """The Gaussian conditional's likelihood of each element of ``y`` with
    the scale ``sigma`` of the same shape (bounded below at 0.11) and the
    mean ``mean`` of that shape, or zero without it: at least 1e-9."""
    sigma = lower_bound(sigma, SCALE_BOUND)
    values = torch.abs(y if mean is None else y - mean)
    upper = _standard_cumulative((0.5 - values) / sigma)
    lower = _standard_cumulative((-0.5 - values) / sigma)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def bits(likelihood):
    """``-sum(log2(likelihood))``: the information content, in bits."""
    return -torch.sum(torch.log2(likelihood))
