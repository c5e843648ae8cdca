"""Minnen et al.'s joint autoregressive and hierarchical prior codec: the
transforms, the context model, the mean-scale entropy model, the rate
and the distortion.

Minnen, Ballé, Toderici, *Joint Autoregressive and Hierarchical Priors
for Learned Image Compression*, NeurIPS 2018 (arXiv:1809.02736), at the
widths of its lower rates, N = M = 192 (CompressAI's ``mbt2018``,
qualities 1-4):

    g_a: conv 5x5/2 N -> GDN -> conv 5x5/2 N -> GDN -> conv 5x5/2 N -> GDN
         -> conv 5x5/2 M                                   (RGB in [0, 1])
    g_s: tconv 5x5/2 N -> IGDN, three times, then tconv 5x5/2 3
    h_a: y -> conv 3x3/1 N -> LeakyReLU -> conv 5x5/2 N -> LeakyReLU
         -> conv 5x5/2 N                                    (y itself, not |y|)
    h_s: tconv 5x5/2 M -> LeakyReLU -> tconv 5x5/2 3M/2 -> LeakyReLU
         -> conv 3x3/1 2M, which is psi
    context model: a masked 5x5/1 conv M -> 2M on y~ (type A: of the 25
         taps only the 12 strictly before the centre in raster order are
         live, the two rows above and the two taps left of the centre),
         which is phi
    entropy parameters: concat(phi, psi) -> 1x1 10M/3 -> LeakyReLU
         -> 1x1 8M/3 -> LeakyReLU -> 1x1 2M, split into the scales (the
         first M) and the means (the last M)

``y``'s likelihood is the Gaussian of mean ``mu`` and scale ``sigma``
(bounded below at 0.11) convolved with U(-1/2, 1/2), ``z``'s the
factorized density at N channels (``ops/entropy_models.py``); the loss
is ``bpp + lambda * 255^2 * mse``. LeakyReLU's slope is 0.01
(CompressAI's; the paper does not state it).

Every conv has a bias. The convolutions are the EAE's TF-SAME ones
(``models/conv_eae.py::conv_same`` / ``conv_transpose_same``), on NHWC
tensors, with TF32 off; every GDN / IGDN site goes through the
hand-written kernel's wrapper ``gdn_nhwc`` at 192 channels, with the
effective ``gamma`` of its stored variable (``ops/entropy_models.py``)
transposed to the kernel's ``[k][c]``, as ``models/hyperprior.py`` does.
The context model is ``conv_same`` of ``kernel * mask``: a masked tap
gets a zero gradient, so Adam never moves it.

**Noise.** Training draws one ``u`` for ``y``: ``y~ = y + u`` feeds the
context model, the rate and ``g_s``, as the paper writes it.
CompressAI's conditional draws a second noise of its own for the rate;
this port does not. ``z~ = z + u'``, as in the hyperprior. Evaluation
rounds ``y`` and ``z``, and the context model reads the rounded ``y``.

Parameters live in one dict, under ``models/hyperprior.py``'s layout and
names: conv kernels OIHW (``*_w<i>``), transposed ones ``(in, out, kh,
kw)``, biases ``*_b<i>``, the GDN variables ``ga_beta<i>`` /
``ga_gamma<i>`` (``gs_`` for the IGDN), the context model's ``cm_w`` /
``cm_b``, the entropy parameters' ``ep_w<i>`` / ``ep_b<i>`` and the
factorized density's under ``fd_``.

**Phases** (``utils/tracing.py``): :func:`rate_distortion` runs the
analysis transform and ``y``'s noise where the caller opened ``forward``,
then marks ``entropy`` (``h_a``, ``z``'s noise, the factorized
likelihood, ``h_s``), ``context`` (the masked conv, the entropy
parameters, the mean-scale likelihood) and ``synthesis`` (``g_s``, the
distortion, the loss).
"""

import math

import torch
import torch.nn.functional as F

from autoencoder_based_image_compression_tpu_torch.models import hyperprior
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import (
    conv_same,
    conv_transpose_same,
)
from autoencoder_based_image_compression_tpu_torch.ops import entropy_models as em
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_nhwc
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase

N = 192
M = 192
CHANNELS = 3
DISTORTION_SCALE = 255.0 ** 2
SLOPE = 0.01
CONTEXT_KERNEL = 5

# (name, kind, in, out, kernel, stride) of every conv, in order.
LAYERS = (
    ("ga_w1", "conv", CHANNELS, N, 5, 2), ("ga_w2", "conv", N, N, 5, 2),
    ("ga_w3", "conv", N, N, 5, 2), ("ga_w4", "conv", N, M, 5, 2),
    ("gs_w1", "tconv", M, N, 5, 2), ("gs_w2", "tconv", N, N, 5, 2),
    ("gs_w3", "tconv", N, N, 5, 2), ("gs_w4", "tconv", N, CHANNELS, 5, 2),
    ("ha_w1", "conv", M, N, 3, 1), ("ha_w2", "conv", N, N, 5, 2),
    ("ha_w3", "conv", N, N, 5, 2),
    ("hs_w1", "tconv", N, M, 5, 2), ("hs_w2", "tconv", M, 3 * M // 2, 5, 2),
    ("hs_w3", "conv", 3 * M // 2, 2 * M, 3, 1),
    ("cm_w", "conv", M, 2 * M, CONTEXT_KERNEL, 1),
    ("ep_w1", "conv", 4 * M, 10 * M // 3, 1, 1),
    ("ep_w2", "conv", 10 * M // 3, 8 * M // 3, 1, 1),
    ("ep_w3", "conv", 8 * M // 3, 2 * M, 1, 1),
)
GDN_SITES = hyperprior.GDN_SITES


def context_mask(kernel=CONTEXT_KERNEL, device=None, dtype=torch.float32):
    """The type-A causal mask ``(kernel, kernel)``: 1 on the taps strictly
    before the centre in raster order, 0 on the centre and after it. Made
    on ``device`` by a comparison, so that a captured step makes it too."""
    taps = torch.arange(kernel * kernel, device=device)
    return (taps < kernel * kernel // 2).to(dtype).reshape(kernel, kernel)


def param_shapes():
    """``{name: shape}`` of every parameter, in the order of
    :func:`init_params`."""
    shapes = {}
    for (name, kind, nb_in, nb_out, kernel, _) in LAYERS:
        shapes[name] = hyperprior.kernel_shape(kind, nb_in, nb_out, kernel)
        shapes[name.replace("_w", "_b")] = (nb_out,)
    for (transform, i) in GDN_SITES:
        (shapes[f"{transform}_beta{i}"], shapes[f"{transform}_gamma{i}"]) = ((N,), (N, N))
    shapes.update({f"fd_{name}": shape for (name, shape) in em.density_shapes(N).items()})
    return shapes


def init_params(generator):
    """Initial parameters, drawn on ``generator``'s device: every conv
    kernel N(0, 1 / (in * k * k)) (the context model's masked taps too,
    which the mask keeps out of every sum), zero biases, GDN ``beta = 1``
    and ``gamma = 0.1 I``, the factorized density at the scale 10
    (``ops/entropy_models.py``), as ``models/hyperprior.py`` draws them."""
    device = generator.device
    params = {}
    for (name, kind, nb_in, nb_out, kernel, _) in LAYERS:
        std = 1.0 / math.sqrt(nb_in * kernel * kernel)
        params[name] = std * torch.randn(hyperprior.kernel_shape(kind, nb_in, nb_out, kernel),
                                         generator=generator, device=device)
        params[name.replace("_w", "_b")] = torch.zeros((nb_out,), device=device)
    for (transform, i) in GDN_SITES:
        (params[f"{transform}_beta{i}"], params[f"{transform}_gamma{i}"]) = em.init_gdn(
            N, device)
    for (name, value) in em.init_density(N, generator).items():
        params[f"fd_{name}"] = value
    return params


def analysis(params, x):
    """``g_a``: images ``(B, H, W, 3)`` in [0, 1] -> ``y`` ``(B, H/16,
    W/16, M)``."""
    disable_tf32()
    for (i, (gamma, beta)) in enumerate(hyperprior.gdn_sites(params, "ga"), start=1):
        x = gdn_nhwc(conv_same(x, params[f"ga_w{i}"], 2) + params[f"ga_b{i}"], gamma, beta)
    return conv_same(x, params["ga_w4"], 2) + params["ga_b4"]


def synthesis(params, y):
    """``g_s``: latents ``(B, h, w, M)`` -> images ``(B, 16 h, 16 w, 3)``."""
    disable_tf32()
    x = y
    for (i, (gamma, beta)) in enumerate(hyperprior.gdn_sites(params, "gs"), start=1):
        x = gdn_nhwc(conv_transpose_same(x, params[f"gs_w{i}"], 2) + params[f"gs_b{i}"], gamma,
                     beta, inverse=True)
    return conv_transpose_same(x, params["gs_w4"], 2) + params["gs_b4"]


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


def hyper_analysis(params, y):
    """``h_a``: ``y`` -> ``z`` ``(B, h/4, w/4, N)``."""
    z = _leaky(conv_same(y, params["ha_w1"], 1) + params["ha_b1"])
    z = _leaky(conv_same(z, params["ha_w2"], 2) + params["ha_b2"])
    return conv_same(z, params["ha_w3"], 2) + params["ha_b3"]


def hyper_synthesis(params, z):
    """``h_s``: ``z`` -> ``psi`` ``(B, 4 h', 4 w', 2M)``."""
    s = _leaky(conv_transpose_same(z, params["hs_w1"], 2) + params["hs_b1"])
    s = _leaky(conv_transpose_same(s, params["hs_w2"], 2) + params["hs_b2"])
    return conv_same(s, params["hs_w3"], 1) + params["hs_b3"]


def context_model(params, y_tilde):
    """The masked conv: ``y~`` -> ``phi`` ``(B, h, w, 2M)``; ``phi`` at a
    position reads only the latents before it in raster order."""
    mask = context_mask(device=y_tilde.device, dtype=y_tilde.dtype)
    return conv_same(y_tilde, params["cm_w"] * mask, 1) + params["cm_b"]


def entropy_parameters(params, phi, psi):
    """``(sigma, mu)`` ``(B, h, w, M)`` each from ``concat(phi, psi)``."""
    e = _leaky(conv_same(torch.cat([phi, psi], dim=-1), params["ep_w1"], 1) + params["ep_b1"])
    e = _leaky(conv_same(e, params["ep_w2"], 1) + params["ep_b2"])
    e = conv_same(e, params["ep_w3"], 1) + params["ep_b3"]
    return (e[..., :M], e[..., M:])


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
        likelihood_z = em.factorized_likelihood(hyperprior.density_params(params), z_tilde)
        psi = hyper_synthesis(params, z_tilde)
    with phase("context"):
        phi = context_model(params, y_tilde)
        (sigma, mu) = entropy_parameters(params, phi, psi)
        likelihood_y = em.gaussian_likelihood(y_tilde, sigma, mu)
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
    return rate_distortion(params, images, lmbda,
                           lambda y: y + hyperprior.uniform(noise_y, y),
                           lambda z: z + hyperprior.uniform(noise_z, z))
