"""bf16-weight serving transforms (the "bf16w+" serving default).

Counterpart of the reference's ``engine/quantized.py``: conv kernels
rounded to bf16 once ahead of time, with precision-surgical fp32 tails;
the encoder's first conv in its space-to-depth form and the decoder's
last transposed conv in its depth-to-space form. Every GDN/IGDN site
calls the hand-written kernel's wrapper ``gdn_nhwc`` in the dtype of
its input (the reference's ``_gdn_fast(..., use_pallas=True)``), so
bf16 activations go through the kernel's bf16 variant.

Precision on the card:

- fp32 convs run in true fp32, TF32 off (``utils.device.disable_tf32``),
  which is at least as tight as the reference's MXU ``HIGH``/``HIGHEST``.
- Where the reference asks an fp32 result of bf16 operands
  (``preferred_element_type=float32``), a bf16 cuDNN conv would return
  bf16. The port runs the conv on the bf16-rounded operands upcast to
  fp32 instead: the products are exact in fp32, so this matches a
  bf16 x bf16 -> fp32 accumulation up to summation order. It matters
  most for the last transposed conv, whose output is pixels in
  [0, 255] where bf16 spacing reaches 1.0.
- Where the reference asks bf16 out of bf16 operands, a plain bf16 conv
  (fp32 accumulation, bf16 result) is used.

The int8 weight store, ``fast_decode_fixed_bw`` and
``fast_roundtrip_scan`` are not ported yet.
"""

import numpy
import torch
import torch.nn.functional as F

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import same_pads
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_nhwc
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32

CONV_NAMES = ("weights_1", "weights_2", "weights_3", "weights_4", "weights_5",
              "weights_6")

# The "bf16w+" serving default: a full-fp32 analysis transform over a
# bf16 synthesis transform. On the card every fp32 conv runs true fp32,
# so the reference's encoder precision choice ("high") has no
# counterpart here.
#
# BF16WPLUS_DEC_HEAD and BF16WPLUS_DEC_EXACT_LATENTS are the port's own
# knobs, both about tconv_4, which runs on operands upcast to fp32
# anyway (see the module docstring), so neither costs time:
# - HEAD: its weights are bf16 but it accumulates into an fp32 output,
#   so its bias add and IGDN_5 run fp32. Rounding that output to bf16
#   ahead of IGDN_5 leaves the worst image about 0.2 dB under the fp32
#   path at every decoder tail level below 3.
# - EXACT_LATENTS: its input, the dequantised latent ``sym * bw + mean``,
#   is not rounded to bf16. The reference's gate was measured on integer
#   symbols into folded weights (:func:`fold_bin_widths_into_decoder`),
#   which bf16 holds exactly; a dequantised latent is not such a number,
#   and rounding it costs the gate at multipliers 4 and 10.
# With both, the worst image stays inside the 0.05 dB gate at
# multipliers 1, 4 and 10 (chip_smoke.py prints the mixes side by side
# and fails otherwise). IGDN_6 and both later tconvs stay bf16.
BF16WPLUS_ENC_TAIL = 3
BF16WPLUS_DEC_TAIL = 0
BF16WPLUS_DEC_HEAD = True
BF16WPLUS_DEC_EXACT_LATENTS = True

_BF16 = torch.bfloat16
_F32 = torch.float32


def _fp32_tail_names(fp32_tail):
    """Decoder kernels kept fp32 for a tail level: 1 = the final 9x9
    tconv, 2 = + tconv_5, 3 = the whole synthesis transform."""
    names = ("weights_6", "weights_5", "weights_4")
    return frozenset(names[:max(0, min(fp32_tail, 3))])


def _fp32_enc_tail_names(fp32_enc_tail):
    """Encoder kernels kept fp32 for a tail level: 1 = the latent conv_3,
    2 = + conv_2, 3 = the whole analysis transform."""
    names = ("weights_3", "weights_2", "weights_1")
    return frozenset(names[:max(0, min(fp32_enc_tail, 3))])


def bf16_weight_params(params, fp32_tail=0, fp32_enc_tail=0):
    """Conv kernels rounded to bf16 once, ahead of time; GDN parameters
    and biases stay fp32. The tail levels keep those kernels fp32: pass
    the same levels to :func:`fast_encode` / :func:`fast_decode`."""
    keep = _fp32_tail_names(fp32_tail) | _fp32_enc_tail_names(fp32_enc_tail)
    return {name: (value.to(_BF16)
                   if name in CONV_NAMES and name not in keep else value)
            for (name, value) in params.items()}


def _run_conv(conv, x_nchw, w, dtype, out_dtype, round_input=True, **kwargs):
    """One conv with operands in ``dtype`` and a result in ``out_dtype``
    (see the module docstring for how bf16 -> fp32 is done).
    ``round_input=False`` leaves ``x`` as it is and rounds only ``w``:
    free where the conv runs on upcast operands anyway."""
    disable_tf32()
    if dtype == _BF16 and out_dtype == _BF16:
        if not round_input:
            raise ValueError("an unrounded input needs an fp32 result.")
        return conv(x_nchw.to(_BF16), w.to(_BF16), **kwargs)
    # fp32 operands, or bf16-rounded operands accumulated in fp32.
    x_nchw = x_nchw.to(dtype if round_input else _F32).to(_F32)
    return conv(x_nchw, w.to(dtype).to(_F32), **kwargs).to(out_dtype)


def _conv_bf16(x, w, stride, out_dtype=_F32, dtype=_BF16):
    """TF-SAME strided conv of NHWC ``x`` with OIHW ``w``."""
    (lo, hi) = same_pads(w.shape[-1], stride)
    x_nchw = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return _run_conv(F.conv2d, x_nchw, w, dtype, out_dtype,
                     stride=stride).permute(0, 2, 3, 1)


def _tconv_bf16(y, w, stride, out_dtype=_F32, dtype=_BF16, round_input=True):
    """Transpose of the TF-SAME strided conv: ``conv_transpose2d`` then
    the crop ``[lo : lo + s*H]``. ``w`` is ``(in, out, kh, kw)``."""
    (lo, _) = same_pads(w.shape[-1], stride)
    (height, width) = (y.shape[1], y.shape[2])
    full = _run_conv(F.conv_transpose2d, y.permute(0, 3, 1, 2), w, dtype,
                     out_dtype, round_input=round_input, stride=stride)
    return full[:, :, lo:lo + stride * height,
                lo:lo + stride * width].permute(0, 2, 3, 1)


def _space_to_depth(x, block=4):
    """(B, H, W, 1) -> (B, H/b, W/b, b*b); channel index = i*b + j for
    pixel (i, j) inside each block."""
    (batch, height, width, _) = x.shape
    x = x.reshape(batch, height // block, block, width // block, block)
    return x.permute(0, 1, 3, 2, 4).reshape(
        batch, height // block, width // block, block * block)


def _depth_to_space(x, block=4):
    """Inverse of :func:`_space_to_depth`."""
    (batch, height_blocks, width_blocks, _) = x.shape
    x = x.reshape(batch, height_blocks, width_blocks, block, block)
    return x.permute(0, 1, 3, 2, 4).reshape(
        batch, height_blocks * block, width_blocks * block, 1)


def _s2d_kernel_from_conv1(w9):
    """The OIHW ``(nb_out, 1, 9, 9)`` stride-4 kernel as the OIHW
    ``(nb_out, 16, 3, 3)`` kernel of the space-to-depth formulation.

    A TF-SAME 9x9 stride-4 conv pads (2, 3); after space-to-depth(4) the
    same linear map is a 3x3 stride-1 SAME conv over 16-channel block
    pixels: tap t (offset d = t - 2 from the output block's origin)
    lands in block a = 1 + floor(d / 4) at intra-block position
    j = d mod 4.
    """
    (dst, src) = ([], [])
    for t_h in range(9):
        (a_h, j_h) = (1 + (t_h - 2) // 4, (t_h - 2) % 4)
        for t_w in range(9):
            (a_w, j_w) = (1 + (t_w - 2) // 4, (t_w - 2) % 4)
            dst.append((j_h * 4 + j_w) * 9 + a_h * 3 + a_w)
            src.append(t_h * 9 + t_w)
    nb_out = w9.shape[0]
    wk = w9.new_zeros((nb_out, 16 * 9))
    # One scatter instead of 81 small copies (each a launch on the card).
    wk[:, dst] = w9.reshape(nb_out, 81)[:, src]
    return wk.reshape(nb_out, 16, 3, 3)


def _conv1_s2d(x, w9, dtype=_BF16, out_dtype=_F32):
    """The encoder's first conv as space-to-depth + 3x3 SAME conv."""
    wk = _s2d_kernel_from_conv1(w9)
    return _run_conv(F.conv2d, _space_to_depth(x).permute(0, 3, 1, 2), wk,
                     dtype, out_dtype, padding=1).permute(0, 2, 3, 1)


def _tconv6_s2d(y, w9, dtype=_BF16):
    """The decoder's last transposed conv as 3x3 conv + depth-to-space.

    The adjoint of ``s2d -> conv(wk, padding 1)`` is
    ``conv_transpose(wk, padding 1) -> d2s``: the reference's flipped,
    IO-swapped 3x3 kernel, which is exactly the TF-SAME 9x9 stride-4
    transposed conv. The result is fp32.
    """
    wk = _s2d_kernel_from_conv1(w9)
    out16 = _run_conv(F.conv_transpose2d, y.permute(0, 3, 1, 2), wk, dtype,
                      _F32, padding=1)
    return _depth_to_space(out16.permute(0, 2, 3, 1))


def _encode_tail_dtypes(fp32_enc_tail):
    """``(c1_dtype, c1_out, c2_dtype, c2_out, c3_dtype)`` for an encoder
    tail level: from the chosen level on, every conv runs fp32 and the
    GDN between fp32 stages pools and scales in fp32."""
    return (_F32 if fp32_enc_tail >= 3 else _BF16,  # conv_1 operand dtype
            _F32 if fp32_enc_tail >= 2 else _BF16,  # conv_1 output -> GDN_1
            _F32 if fp32_enc_tail >= 2 else _BF16,  # conv_2 operand dtype
            _F32 if fp32_enc_tail >= 1 else _BF16,  # conv_2 output -> GDN_2
            _F32 if fp32_enc_tail >= 1 else _BF16)  # conv_3 operand dtype


def fast_encode(qparams, visible_units, learn_bin_widths=True, fp32_enc_tail=0):
    """Analysis transform over bf16-rounded weights, NHWC in and out.

    ``qparams`` comes from :func:`bf16_weight_params` with the same
    ``fp32_enc_tail``. The first conv runs in its space-to-depth form.
    The latents are always fp32.
    """
    p = qparams
    (c1_dtype, c1_out, c2_dtype, c2_out, c3_dtype) = _encode_tail_dtypes(
        fp32_enc_tail)
    x = _conv1_s2d(visible_units, p["weights_1"], dtype=c1_dtype, out_dtype=c1_out)
    x = x + p["biases_1"].to(c1_out)
    x = gdn_nhwc(x, p["gamma_1"], p["beta_1"])
    x = _conv_bf16(x, p["weights_2"], csts.STRIDE_2, out_dtype=c2_out,
                   dtype=c2_dtype)
    x = x + p["biases_2"].to(c2_out)
    x = gdn_nhwc(x, p["gamma_2"], p["beta_2"])
    x = _conv_bf16(x, p["weights_3"], csts.STRIDE_3, dtype=c3_dtype) + p["biases_3"]
    if not learn_bin_widths:
        x = gdn_nhwc(x.to(_F32), p["gamma_3"], p["beta_3"])
    return x.to(_F32)


def _decode_tail_dtypes(fp32_tail, fp32_head=False, fp32_igdn6=False):
    """``(t4_dtype, t4_out, t5_dtype, t5_out, t6_dtype)`` for a decoder
    tail level: 1 = IGDN_6 + final 9x9 tconv, 2 = + tconv_5, 3 = the
    whole synthesis transform. ``fp32_head`` makes tconv_4's output (and
    so IGDN_5) fp32 at any level; ``fp32_igdn6`` makes tconv_5's output
    (and so IGDN_6) fp32 while tconv_5 and the final tconv keep bf16
    operands."""
    return (_F32 if fp32_tail >= 3 else _BF16,   # tconv_4 operand dtype
            _F32 if fp32_tail >= 3 or fp32_head else _BF16,  # tconv_4 output -> IGDN_5
            _F32 if fp32_tail >= 2 else _BF16,   # tconv_5 operand dtype
            _F32 if fp32_tail >= 1 or fp32_igdn6 else _BF16,  # tconv_5 output -> IGDN_6
            _F32 if fp32_tail >= 1 else _BF16)   # final tconv operand dtype


def fold_bin_widths_into_decoder(params, bin_widths):
    """Folds the per-channel dequantiser into ``weights_4``.

    ``tconv(q * bw, w) == tconv(q, w * bw[in-axis])``: after folding,
    :func:`fast_decode` consumes raw integer symbols. ``weights_4`` is
    ``(in, out, kh, kw)`` here, so the bin widths scale axis 0. Only
    valid for the learned-bin-width architecture: with fixed bin widths
    IGDN_4 sits between the symbols and the first tconv and is not
    linear in its input.
    """
    if "gamma_4" in params:
        raise ValueError(
            "dequant folding requires the learned-bin-width architecture "
            "(no IGDN_4 at the bottleneck).")
    folded = dict(params)
    w4 = params["weights_4"]
    if not torch.is_tensor(bin_widths):
        bin_widths = torch.from_numpy(numpy.array(bin_widths, numpy.float32))
    scale = bin_widths.to(device=w4.device, dtype=w4.dtype)
    folded["weights_4"] = w4 * scale.reshape(-1, 1, 1, 1)
    return folded


def fast_decode(qparams, latents, fp32_tail=0, fp32_head=False,
                exact_latents=False, fp32_igdn6=False):
    """Synthesis transform over bf16-rounded weights, NHWC in and out.

    Learned-bin-width architecture. ``latents`` are either the
    dequantised, mean-restored latents (the pipeline passes
    ``sym * bw + mean``) with ``qparams`` from
    :func:`bf16_weight_params`, or raw integer symbols with ``qparams``
    from ``bf16_weight_params(fold_bin_widths_into_decoder(...))``, the
    reference's ``fast_decode`` (the symbols are centred: that call adds
    no map means). Use the same ``fp32_tail`` as for the parameters.

    ``fp32_head`` keeps tconv_4's output and IGDN_5 fp32;
    ``exact_latents`` (needs ``fp32_head``) leaves tconv_4's input
    unrounded; ``fp32_igdn6`` keeps tconv_5's output and IGDN_6 fp32
    (see ``BF16WPLUS_*``). The reconstruction is fp32.
    """
    p = qparams
    (t4_dtype, t4_out, t5_dtype, t5_out, t6_dtype) = _decode_tail_dtypes(
        fp32_tail, fp32_head, fp32_igdn6)
    x = _tconv_bf16(latents.to(_F32), p["weights_4"], csts.STRIDE_3,
                    out_dtype=t4_out, dtype=t4_dtype,
                    round_input=not exact_latents)
    x = x + p["biases_4"].to(t4_out)
    x = gdn_nhwc(x, p["gamma_5"], p["beta_5"], inverse=True)
    x = _tconv_bf16(x, p["weights_5"], csts.STRIDE_2, out_dtype=t5_out,
                    dtype=t5_dtype)
    x = x + p["biases_5"].to(t5_out)
    x = gdn_nhwc(x, p["gamma_6"], p["beta_6"], inverse=True)
    return _tconv6_s2d(x, p["weights_6"], dtype=t6_dtype).to(_F32)
