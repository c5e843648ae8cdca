"""Ballé et al.'s scale-hyperprior codec: the four transforms, the rate
and the distortion.

Ballé, Minnen, Singh, Hwang, Johnston, *Variational image compression
with a scale hyperprior*, ICLR 2018 (arXiv:1802.01436, Fig. 4 and
Sec. 4), at the widths of its lower rates, N = 128 and M = 192:

    g_a: conv 5x5/2 N -> GDN -> conv 5x5/2 N -> GDN -> conv 5x5/2 N -> GDN
         -> conv 5x5/2 M                                   (RGB in [0, 1])
    g_s: tconv 5x5/2 N -> IGDN, three times, then tconv 5x5/2 3
    h_a: |y| -> conv 3x3/1 N -> ReLU -> conv 5x5/2 N -> ReLU -> conv 5x5/2 N
    h_s: tconv 5x5/2 N -> ReLU -> tconv 5x5/2 N -> ReLU -> tconv 3x3/1 M
         -> ReLU, which is sigma

Every conv has a bias. The convolutions are the EAE's TF-SAME ones
(``models/conv_eae.py::conv_same`` / ``conv_transpose_same``: the
paper's padding), on NHWC tensors, with TF32 off; every GDN / IGDN site
goes through the hand-written kernel's wrapper ``gdn_nhwc`` at 128
channels, with the effective ``gamma`` of its stored variable
(``ops/entropy_models.py``) transposed to the kernel's ``[k][c]``. The
entropy models are ``ops/entropy_models.py``'s.

Parameters live in one dict: conv kernels OIHW (``*_w<i>``) for a conv,
``(in, out, kh, kw)`` for a transposed one, biases ``*_b<i>``, GDN
variables ``ga_beta<i>`` / ``ga_gamma<i>`` (``gs_`` for the IGDN), and
the factorized density's under ``fd_``.

**Phases** (``utils/tracing.py``): :func:`rd_loss` runs the analysis
transform and ``y``'s noise where the caller opened ``forward``, then
marks ``entropy`` (``h_a``, ``z``'s noise, the factorized likelihood,
``h_s``, the Gaussian likelihood) and ``synthesis`` (``g_s``, the
distortion, the loss).
"""

import math

import torch

from autoencoder_based_image_compression_tpu_torch.models.conv_eae import (
    conv_same,
    conv_transpose_same,
)
from autoencoder_based_image_compression_tpu_torch.ops import entropy_models as em
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_nhwc
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase

N = 128
M = 192
CHANNELS = 3
DISTORTION_SCALE = 255.0 ** 2

# (name, kind, in, out, kernel, stride) of every conv, in order.
LAYERS = (
    ("ga_w1", "conv", CHANNELS, N, 5, 2), ("ga_w2", "conv", N, N, 5, 2),
    ("ga_w3", "conv", N, N, 5, 2), ("ga_w4", "conv", N, M, 5, 2),
    ("gs_w1", "tconv", M, N, 5, 2), ("gs_w2", "tconv", N, N, 5, 2),
    ("gs_w3", "tconv", N, N, 5, 2), ("gs_w4", "tconv", N, CHANNELS, 5, 2),
    ("ha_w1", "conv", M, N, 3, 1), ("ha_w2", "conv", N, N, 5, 2),
    ("ha_w3", "conv", N, N, 5, 2),
    ("hs_w1", "tconv", N, N, 5, 2), ("hs_w2", "tconv", N, N, 5, 2),
    ("hs_w3", "tconv", N, M, 3, 1),
)
GDN_SITES = (("ga", 1), ("ga", 2), ("ga", 3), ("gs", 1), ("gs", 2), ("gs", 3))


def kernel_shape(kind, nb_in, nb_out, kernel):
    """A conv's kernel shape in the layout its function takes."""
    return ((nb_out, nb_in, kernel, kernel) if kind == "conv"
            else (nb_in, nb_out, kernel, kernel))


def param_shapes():
    """``{name: shape}`` of every parameter, in the order of
    :func:`init_hyperprior_params`."""
    shapes = {}
    for (name, kind, nb_in, nb_out, kernel, _) in LAYERS:
        shapes[name] = kernel_shape(kind, nb_in, nb_out, kernel)
        shapes[name.replace("_w", "_b")] = (nb_out,)
    for (transform, i) in GDN_SITES:
        (shapes[f"{transform}_beta{i}"], shapes[f"{transform}_gamma{i}"]) = ((N,), (N, N))
    shapes.update({f"fd_{name}": shape for (name, shape) in em.density_shapes(N).items()})
    return shapes


def init_hyperprior_params(generator):
    """Initial parameters, drawn on ``generator``'s device: every conv
    kernel N(0, 1 / (in * k * k)), zero biases, GDN ``beta = 1`` and
    ``gamma = 0.1 I``, the factorized density at the scale 10
    (``ops/entropy_models.py``)."""
    device = generator.device
    params = {}
    for (name, kind, nb_in, nb_out, kernel, _) in LAYERS:
        std = 1.0 / math.sqrt(nb_in * kernel * kernel)
        params[name] = std * torch.randn(kernel_shape(kind, nb_in, nb_out, kernel),
                                         generator=generator, device=device)
        params[name.replace("_w", "_b")] = torch.zeros((nb_out,), device=device)
    for (transform, i) in GDN_SITES:
        (params[f"{transform}_beta{i}"], params[f"{transform}_gamma{i}"]) = em.init_gdn(
            N, device)
    for (name, value) in em.init_density(N, generator).items():
        params[f"fd_{name}"] = value
    return params


def density_params(params):
    """The factorized density's parameters under their own names."""
    return {name[len("fd_"):]: value for (name, value) in params.items()
            if name.startswith("fd_")}


def gdn_sites(params, transform):
    """``[(gamma, beta)]`` of the transform's three GDN sites: the effective
    values of their stored variables, gamma transposed to the kernel's
    ``[k][c]``. The three sites go through the reparameterisation
    together, a few launches where one a site took seven (and twice that
    in the backward)."""
    gammas = em.gdn_gamma(torch.stack([params[f"{transform}_gamma{i}"] for i in (1, 2, 3)]))
    betas = em.gdn_beta(torch.stack([params[f"{transform}_beta{i}"] for i in (1, 2, 3)]))
    return list(zip(gammas.transpose(-1, -2).contiguous(), betas))


def analysis(params, x):
    """``g_a``: images ``(B, H, W, 3)`` in [0, 1] -> ``y`` ``(B, H/16,
    W/16, M)``."""
    disable_tf32()
    for (i, (gamma, beta)) in enumerate(gdn_sites(params, "ga"), start=1):
        x = gdn_nhwc(conv_same(x, params[f"ga_w{i}"], 2) + params[f"ga_b{i}"], gamma, beta)
    return conv_same(x, params["ga_w4"], 2) + params["ga_b4"]


def synthesis(params, y):
    """``g_s``: latents ``(B, h, w, M)`` -> images ``(B, 16 h, 16 w, 3)``."""
    disable_tf32()
    x = y
    for (i, (gamma, beta)) in enumerate(gdn_sites(params, "gs"), start=1):
        x = gdn_nhwc(conv_transpose_same(x, params[f"gs_w{i}"], 2) + params[f"gs_b{i}"], gamma,
                     beta, inverse=True)
    return conv_transpose_same(x, params["gs_w4"], 2) + params["gs_b4"]


def hyper_analysis(params, y):
    """``h_a``: ``y`` -> ``z`` ``(B, h/4, w/4, N)``."""
    z = torch.relu(conv_same(torch.abs(y), params["ha_w1"], 1) + params["ha_b1"])
    z = torch.relu(conv_same(z, params["ha_w2"], 2) + params["ha_b2"])
    return conv_same(z, params["ha_w3"], 2) + params["ha_b3"]


def hyper_synthesis(params, z):
    """``h_s``: ``z`` -> ``sigma`` ``(B, 4 h', 4 w', M)``."""
    s = torch.relu(conv_transpose_same(z, params["hs_w1"], 2) + params["hs_b1"])
    s = torch.relu(conv_transpose_same(s, params["hs_w2"], 2) + params["hs_b2"])
    return torch.relu(conv_transpose_same(s, params["hs_w3"], 1) + params["hs_b3"])


def uniform(noise, like):
    """U[-1/2, 1/2) of ``like``'s shape from the generator ``noise``, or
    ``noise`` itself (two implementations fed the same numbers)."""
    if isinstance(noise, torch.Generator):
        return torch.rand(like.shape, generator=noise, device=like.device,
                          dtype=like.dtype) - 0.5
    if noise.shape != like.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for {tuple(like.shape)}.")
    return noise


def rate_distortion(params, images, lmbda, y_tilde_of, z_tilde_of):
    """``(loss, parts)`` of images ``(B, H, W, 3)`` in [0, 1]: ``y`` and
    ``z`` go to the entropy models and the synthesis as ``y_tilde_of(y)``
    and ``z_tilde_of(z)`` (noise in training, rounding in evaluation).
    ``loss = bpp + lmbda * 255^2 * mse``, ``bpp`` the information of both
    latents over ``B * H * W``; ``parts`` holds ``bpp``, ``bpp_y``,
    ``bpp_z``, ``mse`` and the reconstruction."""
    y = analysis(params, images)
    y_tilde = y_tilde_of(y)
    with phase("entropy"):
        z = hyper_analysis(params, y)
        z_tilde = z_tilde_of(z)
        likelihood_z = em.factorized_likelihood(density_params(params), z_tilde)
        sigma = hyper_synthesis(params, z_tilde)
        likelihood_y = em.gaussian_likelihood(y_tilde, sigma)
    with phase("synthesis"):
        reconstruction = synthesis(params, y_tilde)
        pixels = images.shape[0] * images.shape[1] * images.shape[2]
        (bpp_y, bpp_z) = (em.bits(likelihood_y) / pixels, em.bits(likelihood_z) / pixels)
        bpp = bpp_y + bpp_z
        mse = torch.mean(torch.square(images - reconstruction))
        loss = bpp + lmbda * DISTORTION_SCALE * mse
    return (loss, {"bpp": bpp, "bpp_y": bpp_y, "bpp_z": bpp_z, "mse": mse,
                   "reconstruction": reconstruction})


def rd_loss(params, images, noise, lmbda):
    """The training objective: :func:`rate_distortion` with ``y~ = y + u``
    and ``z~ = z + u'``, ``u`` then ``u'`` uniform on [-1/2, 1/2) drawn
    from the generator ``noise`` in that order, or ``noise = (u, u')``."""
    (noise_y, noise_z) = (noise, noise) if isinstance(noise, torch.Generator) else noise
    return rate_distortion(params, images, lmbda, lambda y: y + uniform(noise_y, y),
                           lambda z: z + uniform(noise_z, z))
