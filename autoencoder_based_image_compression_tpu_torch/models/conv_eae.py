"""Convolutional GDN entropy autoencoder: the fp32 transforms, their
initialisation and the weight-decay norm.

Counterpart of the reference's ``models/conv_eae.py``:

    encoder: conv 9x9 s4 -> GDN -> conv 5x5 s2 -> GDN -> conv 5x5 s2
             [-> GDN_3 iff bin widths are NOT learned]
    decoder: [IGDN_4 iff bin widths are NOT learned]
             tconv 5x5 s2 -> IGDN -> tconv 5x5 s2 -> IGDN -> tconv 9x9 s4

Public functions take and return NHWC tensors and the parameter dict of
``train.checkpoint.params_from_jax`` (OIHW conv kernels, same names as
the reference). Inside, an NHWC tensor is handed to the convolutions as
its NCHW view, which is channels-last in memory, so the convolutions
run channels-last and every GDN input is a C-contiguous (rows, 128)
matrix. Every GDN/IGDN site goes through the hand-written kernel's
wrapper, which is differentiable, so the same ``encode`` and ``decode``
serve and train. fp32 convolutions run with TF32 off, forward and
backward.
"""

import torch
import torch.nn.functional as F

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.ops.gdn import init_gdn_gamma
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_nhwc
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32


def same_pads(kernel, stride):
    """TF 'SAME' pads ``(lo, hi)`` of a stride-``stride`` conv on inputs
    whose size is a multiple of the stride: (2, 3) for 9/4, (1, 2) for 5/2."""
    lo = (kernel - stride) // 2
    return (lo, kernel - stride - lo)


def conv_same(x_nhwc, w, stride):
    """Strided conv with TF 'SAME' padding, padded explicitly.

    ``w`` is OIHW. PyTorch's ``padding="same"`` is refused at stride > 1
    and its symmetric padding cannot express the (2, 3) case.
    """
    (lo, hi) = same_pads(w.shape[-1], stride)
    x = F.pad(x_nhwc.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.conv2d(x, w, stride=stride).permute(0, 2, 3, 1)


def conv_transpose_same(y_nhwc, w, stride):
    """The exact adjoint of :func:`conv_same` with the same weight.

    ``w`` is ``(in, out, kh, kw)``. ``conv_transpose2d`` without padding
    gives the full ``(H-1)*s + k`` output, cropped to ``[lo : lo + s*H]``
    on both axes (the crop the SAME pads (lo, hi) imply).
    """
    (lo, _) = same_pads(w.shape[-1], stride)
    (height, width) = (y_nhwc.shape[1], y_nhwc.shape[2])
    full = F.conv_transpose2d(y_nhwc.permute(0, 3, 1, 2), w, stride=stride)
    cropped = full[:, :, lo:lo + stride * height, lo:lo + stride * width]
    return cropped.permute(0, 2, 3, 1)


def init_conv_eae_params(generator, learn_bin_widths):
    """Initialises the parameter dict, drawing from ``generator`` on its
    device.

    Distributions of the reference (``EntropyAutoencoder.py:130-224``):
    conv kernels N(0, 0.01 / 0.02 / 0.05) by layer, zero biases,
    symmetric uniform GDN gammas, unit betas. Kernels are born in this
    package's layouts: OIHW for the encoder, ``(in, out, kh, kw)`` for
    the decoder's transposed convs. Without learned bin widths a
    GDN_3 / IGDN_4 pair wraps the bottleneck.
    """
    (n1, n2, n3) = (csts.NB_MAPS_1, csts.NB_MAPS_2, csts.NB_MAPS_3)
    (k1, k2, k3) = (csts.WIDTH_KERNEL_1, csts.WIDTH_KERNEL_2, csts.WIDTH_KERNEL_3)
    device = generator.device

    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)

    def zeros(size):
        return torch.zeros(size, device=device, dtype=torch.float32)

    def ones(size):
        return torch.ones(size, device=device, dtype=torch.float32)

    def gamma(size):
        return init_gdn_gamma(generator, size, csts.MIN_GAMMA_BETA)

    params = {
        "weights_1": normal((n1, 1, k1, k1), 0.01), "biases_1": zeros(n1),
        "gamma_1": gamma(n1), "beta_1": ones(n1),
        "weights_2": normal((n2, n1, k2, k2), 0.02), "biases_2": zeros(n2),
        "gamma_2": gamma(n2), "beta_2": ones(n2),
        "weights_3": normal((n3, n2, k3, k3), 0.05), "biases_3": zeros(n3),
        "weights_4": normal((n3, n2, k3, k3), 0.05), "biases_4": zeros(n2),
        "gamma_5": gamma(n2), "beta_5": ones(n2),
        "weights_5": normal((n2, n1, k2, k2), 0.02), "biases_5": zeros(n1),
        "gamma_6": gamma(n1), "beta_6": ones(n1),
        "weights_6": normal((n1, 1, k1, k1), 0.01),
    }
    if not learn_bin_widths:
        params.update({"gamma_3": gamma(n3), "beta_3": ones(n3),
                       "gamma_4": gamma(n3), "beta_4": ones(n3)})
    return params


def weight_l2_norm(params):
    """Cumulated l2 loss ``sum(w**2) / 2`` over the 6 conv kernels only
    (reference ``components.py:144-167``: GDN parameters and biases are
    exempt from weight decay). Does not depend on the kernels' layout."""
    return sum(0.5 * torch.sum(torch.square(params[name])) for name in csts.CONV_NAMES)


def nb_parameters(params):
    """Total parameter count (reference ``eae/note_eae.txt``: 1,758,848
    with the GDN_3 / IGDN_4 pair)."""
    return sum(p.numel() for p in params.values())


def analysis(params, visible_units):
    """Analysis transform up to the latent conv (before GDN_3)."""
    disable_tf32()
    x = conv_same(visible_units, params["weights_1"], csts.STRIDE_1) + params["biases_1"]
    x = gdn_nhwc(x, params["gamma_1"], params["beta_1"])
    x = conv_same(x, params["weights_2"], csts.STRIDE_2) + params["biases_2"]
    x = gdn_nhwc(x, params["gamma_2"], params["beta_2"])
    return conv_same(x, params["weights_3"], csts.STRIDE_3) + params["biases_3"]


def encode(params, visible_units, learn_bin_widths):
    """Visible units ``(B, H, W, 1)`` -> latents ``(B, H/16, W/16, 128)``."""
    x = analysis(params, visible_units)
    if not learn_bin_widths:
        x = gdn_nhwc(x, params["gamma_3"], params["beta_3"])
    return x


def decode(params, y_tilde, learn_bin_widths):
    """(Quantised) latents -> reconstruction ``(B, H, W, 1)``, fp32."""
    disable_tf32()
    x = y_tilde
    if not learn_bin_widths:
        x = gdn_nhwc(x, params["gamma_4"], params["beta_4"], inverse=True)
    x = conv_transpose_same(x, params["weights_4"], csts.STRIDE_3) + params["biases_4"]
    x = gdn_nhwc(x, params["gamma_5"], params["beta_5"], inverse=True)
    x = conv_transpose_same(x, params["weights_5"], csts.STRIDE_2) + params["biases_5"]
    x = gdn_nhwc(x, params["gamma_6"], params["beta_6"], inverse=True)
    return conv_transpose_same(x, params["weights_6"], csts.STRIDE_1)
