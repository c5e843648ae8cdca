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

Where nothing is differentiated, ``decode`` computes each transposed
conv as a forward conv into its stride^2 output phases followed by a
depth-to-space (:func:`conv_transpose_phases`): cuDNN runs
``conv_transpose2d`` as its backward-data pass, which sums fp32 with
atomics, where its forward convs repeat their bits, so two decodes of
the same latents are equal. With grad, ``decode`` keeps
``conv_transpose2d``, whose backward is a forward conv in either form.

``encode_stacked`` and ``decode_stacked`` run M models at once over
parameters with a leading model axis (the gamma ladder): the models'
maps sit side by side in the channels, every conv is grouped over the
models (the first one is a single conv with M * 128 outputs of the
shared batch), and every GDN site is one launch of the stacked kernel.
"""

import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.ops.gdn import init_gdn_gamma
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_nhwc,
    gdn_stacked_nhwc,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32

_DECODER_PARAMS = ("gamma_4", "beta_4", "weights_4", "biases_4", "gamma_5", "beta_5",
                   "weights_5", "biases_5", "gamma_6", "beta_6", "weights_6")


def same_pads(kernel, stride):
    """TF 'SAME' pads ``(lo, hi)`` of a stride-``stride`` conv on inputs
    whose size is a multiple of the stride: (2, 3) for 9/4, (1, 2) for 5/2."""
    lo = (kernel - stride) // 2
    return (lo, kernel - stride - lo)


def conv_same(x_nhwc, w, stride, groups=1):
    """Strided conv with TF 'SAME' padding, padded explicitly.

    ``w`` is OIHW. PyTorch's ``padding="same"`` is refused at stride > 1
    and its symmetric padding cannot express the (2, 3) case.
    """
    (lo, hi) = same_pads(w.shape[-1], stride)
    x = F.pad(x_nhwc.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.conv2d(x, w, stride=stride, groups=groups).permute(0, 2, 3, 1)


def conv_transpose_same(y_nhwc, w, stride, groups=1):
    """The exact adjoint of :func:`conv_same` with the same weight.

    ``w`` is ``(in, out, kh, kw)``. ``conv_transpose2d`` without padding
    gives the full ``(H-1)*s + k`` output, cropped to ``[lo : lo + s*H]``
    on both axes (the crop the SAME pads (lo, hi) imply).
    """
    (lo, _) = same_pads(w.shape[-1], stride)
    (height, width) = (y_nhwc.shape[1], y_nhwc.shape[2])
    full = F.conv_transpose2d(y_nhwc.permute(0, 3, 1, 2), w, stride=stride, groups=groups)
    cropped = full[:, :, lo:lo + stride * height, lo:lo + stride * width]
    return cropped.permute(0, 2, 3, 1)


# --- transposed convs as forward convs into their output phases ----------

def _depth_to_space(x, block=4):
    """(B, H/b, W/b, b*b*C) -> (B, H, W, C), channel ``(i*b + j)*C + c``
    for map ``c`` of pixel (i, j) inside each block (the inverse of a
    space-to-depth)."""
    (batch, height_blocks, width_blocks, _) = x.shape
    x = x.reshape(batch, height_blocks, width_blocks, block, block, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        batch, height_blocks * block, width_blocks * block, -1)


@functools.lru_cache(maxsize=None)
def _s2d_tap_index(device):
    """For each of the 81 taps of the 9x9 kernel, in order, its place in
    the flattened (16, 3, 3) space-to-depth kernel, as an index tensor on
    ``device`` (made once per device: building it at every call would be
    a host-to-device copy per transform, which a CUDA-graph capture
    refuses)."""
    index = []
    for t_h in range(9):
        (a_h, j_h) = (1 + (t_h - 2) // 4, (t_h - 2) % 4)
        for t_w in range(9):
            (a_w, j_w) = (1 + (t_w - 2) // 4, (t_w - 2) % 4)
            index.append((j_h * 4 + j_w) * 9 + a_h * 3 + a_w)
    return torch.tensor(index, dtype=torch.int64, device=device)


def _s2d_kernel_from_conv1(w9):
    """The OIHW ``(nb_out, 1, 9, 9)`` stride-4 kernel as the OIHW
    ``(nb_out, 16, 3, 3)`` kernel of the space-to-depth formulation.

    A TF-SAME 9x9 stride-4 conv pads (2, 3); after space-to-depth(4) the
    same linear map is a 3x3 stride-1 SAME conv over 16-channel block
    pixels: tap t (offset d = t - 2 from the output block's origin)
    lands in block a = 1 + floor(d / 4) at intra-block position
    j = d mod 4.
    """
    nb_out = w9.shape[0]
    wk = w9.new_zeros((nb_out, 16 * 9))
    # One scatter instead of 81 small copies (each a launch on the card).
    wk[:, _s2d_tap_index(w9.device)] = w9.reshape(nb_out, 81)
    return wk.reshape(nb_out, 16, 3, 3)


@functools.lru_cache(maxsize=None)
def _tconv4_tap_index(device):
    """For each of the 4 x 3 x 3 taps of the phase kernels, in order, its
    tap of the flattened 5 x 5 kernel, or 25 (a zero) where the phase has
    none; an index tensor made once per device."""
    (lo, _) = same_pads(5, csts.STRIDE_3)
    index = []
    for p_h in range(2):
        for p_w in range(2):
            for a_h in range(3):
                for a_w in range(3):
                    (t_h, t_w) = (p_h + lo + 2 - 2 * a_h, p_w + lo + 2 - 2 * a_w)
                    index.append(t_h * 5 + t_w if 0 <= t_h < 5 and 0 <= t_w < 5 else 25)
    return torch.tensor(index, dtype=torch.int64, device=device)


# The phase kernels of each transposed-conv kernel tensor, built at its
# first use outside a capture (keyed by the tensor, rebuilt if it is
# written to).
_phase_kernels = {5: WeakIdKeyDictionary(), 9: WeakIdKeyDictionary()}


def _built_once(w, build):
    """``build(w)``, kept for the tensor ``w`` until it is written to."""
    cache = _phase_kernels[w.shape[-1]]
    cached = cache.get(w)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    wk = build(w)
    # Inside a capture the kernel is computed only when the graph
    # replays, so what is built there is not kept for eager calls.
    if not (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        cache[w] = (w._version, wk)
    return wk


def _tconv4_phase_kernel(w5):
    """The ``(in, out, 5, 5)`` stride-2 transposed-conv kernel (tconv_4,
    tconv_5) as the OIHW ``(4 * out, in, 3, 3)`` kernel of its 2 x 2
    phase decomposition, built once per kernel tensor.

    Output pixel ``2m + p`` of the TF-SAME transposed conv (pads (1, 2),
    full output cropped at ``lo = 1``) sums input ``m + a - 1`` times tap
    ``p + lo + 2 - 2a`` for ``a`` in 0..2 (where that tap exists), which
    is a 3 x 3 stride-1 correlation with padding 1 per output phase; the
    four phases are output channel blocks ``(p_h * 2 + p_w) * out``.
    """
    def build(w5):
        (nb_in, nb_out) = w5.shape[:2]
        taps = torch.cat([w5.reshape(nb_in, nb_out, 25), w5.new_zeros((nb_in, nb_out, 1))],
                         dim=2)
        wk = taps[:, :, _tconv4_tap_index(w5.device)].reshape(nb_in, nb_out, 4, 3, 3)
        return wk.permute(2, 1, 0, 3, 4).reshape(4 * nb_out, nb_in, 3, 3).contiguous()

    return _built_once(w5, build)


def _tconv6_phase_kernel(w9):
    """The ``(in, 1, 9, 9)`` stride-4 transposed-conv kernel (tconv_6) as
    the OIHW ``(16, in, 3, 3)`` kernel of its 16 output phases, built
    once per kernel tensor: the adjoint of the space-to-depth form of a
    9x9 stride-4 conv (:func:`_s2d_kernel_from_conv1`) is the transposed
    3x3 conv with that kernel, which at stride 1 is the forward conv with
    the channel axes swapped and the taps flipped."""
    return _built_once(w9, lambda w9: _s2d_kernel_from_conv1(w9).transpose(0, 1).flip(
        -2, -1).contiguous())


def conv_transpose_phases(y_nhwc, w, stride):
    """:func:`conv_transpose_same` for the decoder's two kernel shapes
    (5 x 5 at stride 2, 9 x 9 at stride 4) as a forward 3 x 3 conv into
    the stride^2 output phases, then depth-to-space. Equal to it up to
    the order of the sums, and it repeats its bits on the card."""
    if (w.shape[-1], stride) == (5, 2):
        kernel = _tconv4_phase_kernel(w)
    elif (w.shape[-1], stride) == (9, 4):
        kernel = _tconv6_phase_kernel(w)
    else:
        raise ValueError(f"no phase form for a {w.shape[-1]} x {w.shape[-1]} kernel at "
                         f"stride {stride}.")
    out = F.conv2d(y_nhwc.permute(0, 3, 1, 2), kernel, padding=1)
    return _depth_to_space(out.permute(0, 2, 3, 1), block=stride)


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


def weight_l2_norms(params):
    """:func:`weight_l2_norm` of each model of stacked parameters, ``(M,)``."""
    return sum(0.5 * torch.square(params[name]).flatten(1).sum(1) for name in csts.CONV_NAMES)


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
    """(Quantised) latents -> reconstruction ``(B, H, W, 1)``, fp32.

    The transposed convs take their phase form unless an operand is
    differentiated (see the module docstring)."""
    disable_tf32()
    operands = [y_tilde] + [params[name] for name in _DECODER_PARAMS if name in params]
    differentiated = torch.is_grad_enabled() and any(t.requires_grad for t in operands)
    return _decode(params, y_tilde, learn_bin_widths,
                   conv_transpose_same if differentiated else conv_transpose_phases)


def _decode(params, y_tilde, learn_bin_widths, tconv):
    """:func:`decode` with the transposed convs ``tconv``."""
    x = y_tilde
    if not learn_bin_widths:
        x = gdn_nhwc(x, params["gamma_4"], params["beta_4"], inverse=True)
    x = tconv(x, params["weights_4"], csts.STRIDE_3) + params["biases_4"]
    x = gdn_nhwc(x, params["gamma_5"], params["beta_5"], inverse=True)
    x = tconv(x, params["weights_5"], csts.STRIDE_2) + params["biases_5"]
    x = gdn_nhwc(x, params["gamma_6"], params["beta_6"], inverse=True)
    return tconv(x, params["weights_6"], csts.STRIDE_1)


# --- M models at once (the gamma ladder) -----------------------------------

# The conv sites that run as M convs on the models' channel slices of the
# stacked tensors instead of one conv grouped over the models. tconv_6
# (one output map a model): grouped, its backward-data pass sums a
# model's group in another order for M groups than for one on the CPU,
# so a block of one model and the whole ladder part by Adam's sign flips.
SEPARATE_SITES = frozenset({"tconv_6"})


def _conv_stacked(site, x_nhwc, w, stride, transposed=False, separate=SEPARATE_SITES):
    """Conv site ``site`` of M models: ``w`` is the stacked kernel (M,
    ...), ``x_nhwc`` the models' maps side by side (or the shared batch,
    ``conv_1``). One grouped conv, or M convs on channel slices for a
    site in ``separate``; the same sums either way."""
    nb_models = w.shape[0]
    conv = conv_transpose_same if transposed else conv_same
    if site in separate:
        width = x_nhwc.shape[-1] // nb_models
        shared = site == "conv_1"
        return torch.cat([conv(x_nhwc if shared else x_nhwc[..., m * width:(m + 1) * width],
                               w[m], stride) for m in range(nb_models)], dim=-1)
    groups = 1 if site == "conv_1" else nb_models
    return conv(x_nhwc, w.reshape(nb_models * w.shape[1], *w.shape[2:]), stride, groups)


def encode_stacked(params, visible_units, learn_bin_widths):
    """:func:`encode` of M models on one batch: ``params`` has a leading
    model axis on every leaf; visible units ``(B, H, W, 1)`` -> the
    models' latents side by side, ``(B, H/16, W/16, M * 128)``."""
    disable_tf32()

    def flat(name):
        return params[name].reshape(-1)

    x = _conv_stacked("conv_1", visible_units, params["weights_1"], csts.STRIDE_1) + flat(
        "biases_1")
    x = gdn_stacked_nhwc(x, params["gamma_1"], params["beta_1"])
    x = _conv_stacked("conv_2", x, params["weights_2"], csts.STRIDE_2) + flat("biases_2")
    x = gdn_stacked_nhwc(x, params["gamma_2"], params["beta_2"])
    x = _conv_stacked("conv_3", x, params["weights_3"], csts.STRIDE_3) + flat("biases_3")
    if not learn_bin_widths:
        x = gdn_stacked_nhwc(x, params["gamma_3"], params["beta_3"])
    return x


def decode_stacked(params, y_tilde, learn_bin_widths):
    """:func:`decode` of M models: the models' latents side by side
    ``(B, h, w, M * 128)`` -> their reconstructions ``(B, H, W, M)``,
    channel ``m`` model ``m``'s. Transposed convs as ``conv_transpose2d``
    grouped over the models, with grad or without."""
    disable_tf32()

    def flat(name):
        return params[name].reshape(-1)

    x = y_tilde
    if not learn_bin_widths:
        x = gdn_stacked_nhwc(x, params["gamma_4"], params["beta_4"], inverse=True)
    x = _conv_stacked("tconv_4", x, params["weights_4"], csts.STRIDE_3, True) + flat("biases_4")
    x = gdn_stacked_nhwc(x, params["gamma_5"], params["beta_5"], inverse=True)
    x = _conv_stacked("tconv_5", x, params["weights_5"], csts.STRIDE_2, True) + flat("biases_5")
    x = gdn_stacked_nhwc(x, params["gamma_6"], params["beta_6"], inverse=True)
    return _conv_stacked("tconv_6", x, params["weights_6"], csts.STRIDE_1, True)
