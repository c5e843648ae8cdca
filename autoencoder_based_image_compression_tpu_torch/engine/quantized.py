"""Low-precision serving transforms: bf16-rounded or int8-stored kernels.

Counterpart of the reference's ``engine/quantized.py``: conv kernels
rounded to bf16 once ahead of time (``bf16_weight_params``, with
precision-surgical fp32 tails: "bf16w" and the "bf16w+" serving
default) or stored int8 with per-output-channel fp32 scales
(``quantize_params_int8``: "int8"); the dequantiser folded into the
decoder's first kernel; the encoder's first conv in its space-to-depth
form and the decoder's last transposed conv in its depth-to-space form;
the fixed-bin-width decode (``fast_decode_fixed_bw``) and the K-batch
round trip (``fast_roundtrip_scan``, eager or as one CUDA graph). Every
GDN/IGDN site calls the hand-written kernel's wrapper ``gdn_nhwc`` in
the dtype of its input (the reference's ``_gdn_fast(...,
use_pallas=True)``, so there is no such knob), and bf16 activations go
through the kernel's bf16 variant.

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
"""

import functools

import numpy
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import same_pads
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_nhwc
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32

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
# The scan path's "bf16w+" (:func:`fast_roundtrip_scan`, what the bench
# times): integer symbols into a decoder whose first kernel holds the
# bin widths. There the latent is exact in bf16 and the one rounding the
# pipeline's mix has not is that of the folded kernel ``w4 * bw``: with
# the fp32 head alone the worst image misses the gate at multiplier 10,
# so the folded ``weights_4`` stays fp32 (tconv_4 runs on fp32 operands
# anyway). The keywords of :func:`fast_roundtrip_scan`.
BF16WPLUS_SCAN_MIX = {"fp32_enc_tail": BF16WPLUS_ENC_TAIL, "fp32_tail": BF16WPLUS_DEC_TAIL,
                      "fp32_tconv4": True}
# The serving variants of the scan path: (weight store, knobs).
SCAN_VARIANTS = {"int8": ("int8", {}), "bf16w": ("bf16", {}),
                 "bf16w+": ("bf16", BF16WPLUS_SCAN_MIX)}

_BF16 = torch.bfloat16
_F32 = torch.float32
# Output-channel axis of each kernel in this package's layouts: encoder
# kernels are OIHW, decoder kernels ``(in, out, kh, kw)``.
_OUT_AXIS = {"weights_1": 0, "weights_2": 0, "weights_3": 0,
             "weights_4": 1, "weights_5": 1, "weights_6": 1}
_ENCODER_KERNELS = ("weights_1", "weights_2", "weights_3")
_DECODER_KERNELS = ("weights_4", "weights_5", "weights_6")


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


def bf16_weight_params(params, fp32_tail=0, fp32_enc_tail=0, fp32_tconv4=False):
    """Conv kernels rounded to bf16 once, ahead of time; GDN parameters
    and biases stay fp32. The tail levels keep those kernels fp32, and
    ``fp32_tconv4`` keeps ``weights_4`` alone: pass the same values to
    :func:`fast_encode` / :func:`fast_decode`."""
    keep = _fp32_tail_names(fp32_tail) | _fp32_enc_tail_names(fp32_enc_tail)
    if fp32_tconv4:
        keep = keep | {"weights_4"}
    return {name: (value.to(_BF16)
                   if name in csts.CONV_NAMES and name not in keep else value)
            for (name, value) in params.items()}


def quantize_params_int8(params):
    """Conv kernels as int8 with per-output-channel fp32 scales.

    ``scale = max(absmax, 1e-12) / 127`` over everything but the output
    axis (kept as a size-1-elsewhere tensor), entries
    ``clip(round(w / scale), -127, 127)``. GDN parameters and biases
    stay fp32. Each conv entry becomes ``{"int8": ..., "scale": ...}``.
    Fold the bin widths first (:func:`fold_bin_widths_into_decoder`),
    then quantise, where the decoder is to take integer symbols.
    """
    qparams = {}
    for (name, value) in params.items():
        if name in csts.CONV_NAMES:
            reduce_axes = tuple(a for a in range(value.dim()) if a != _OUT_AXIS[name])
            absmax = value.abs().amax(dim=reduce_axes, keepdim=True)
            scale = absmax.clamp_min(1e-12) / 127.0
            int8 = torch.round(value / scale).clamp(-127, 127).to(torch.int8)
            qparams[name] = {"int8": int8, "scale": scale.to(_F32)}
        else:
            qparams[name] = value
    return qparams


def dequantize_int8_params(qparams, dtype=_BF16, names=csts.CONV_NAMES):
    """Kernels ``names`` in ``dtype`` from the int8 store; plain tensors
    pass through unchanged, so every fast transform takes either store.
    Each transform calls this first for the kernels it runs: the store
    stays int8 in memory and a call pays one convert, one multiply and
    one cast per kernel (small elementwise launches on the card)."""
    return {name: ((value["int8"].to(_F32) * value["scale"]).to(dtype)
                   if isinstance(value, dict) and name in names else value)
            for (name, value) in qparams.items()}


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
    """Inverse of :func:`_space_to_depth`, also for ``C`` maps a pixel:
    (B, H/b, W/b, b*b*C) -> (B, H, W, C), channel ``(i*b + j)*C + c``
    for map ``c`` of pixel (i, j) inside each block."""
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
    transposed conv. A stride-1 transposed conv is the forward conv with
    that kernel written out (channel axes swapped, taps flipped), which
    cuDNN sums without atomics: its backward-data pass does not repeat
    its bits on small decodes (a batch of 2 of 64 x 96 on an H100). The
    result is fp32.
    """
    wk = _s2d_kernel_from_conv1(w9).transpose(0, 1).flip(-2, -1)
    out16 = _run_conv(F.conv2d, y.permute(0, 3, 1, 2), wk, dtype, _F32, padding=1)
    return _depth_to_space(out16.permute(0, 2, 3, 1))


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


# The phase kernels of each tconv_4 kernel tensor, built at its first use
# outside a capture (keyed by the tensor, rebuilt if it is written to).
_tconv4_phase_kernels = WeakIdKeyDictionary()


def _tconv4_phase_kernel(w5):
    """The ``(in, out, 5, 5)`` stride-2 transposed-conv kernel as the OIHW
    ``(4 * out, in, 3, 3)`` kernel of its 2 x 2 phase decomposition.

    Output pixel ``2m + p`` of the TF-SAME transposed conv (pads (1, 2),
    full output cropped at ``lo = 1``) sums input ``m + a - 1`` times tap
    ``p + lo + 2 - 2a`` for ``a`` in 0..2 (where that tap exists), which
    is a 3 x 3 stride-1 correlation with padding 1 per output phase; the
    four phases are output channel blocks ``(p_h * 2 + p_w) * out``.
    """
    cached = _tconv4_phase_kernels.get(w5)
    if cached is not None and cached[0] == w5._version:
        return cached[1]
    (nb_in, nb_out) = w5.shape[:2]
    taps = torch.cat([w5.reshape(nb_in, nb_out, 25), w5.new_zeros((nb_in, nb_out, 1))], dim=2)
    wk = taps[:, :, _tconv4_tap_index(w5.device)].reshape(nb_in, nb_out, 4, 3, 3)
    wk = wk.permute(2, 1, 0, 3, 4).reshape(4 * nb_out, nb_in, 3, 3).contiguous()
    # Inside a capture the kernel is computed only when the graph
    # replays, so what is built there is not kept for eager calls.
    if not (w5.is_cuda and torch.cuda.is_current_stream_capturing()):
        _tconv4_phase_kernels[w5] = (w5._version, wk)
    return wk


def _tconv4_phases(y, w5, out_dtype=_F32, dtype=_BF16, round_input=True):
    """The decoder's first transposed conv (5 x 5, stride 2, TF-SAME) as a
    forward 3 x 3 conv into its four output phases, then depth-to-space.

    Equal to :func:`_tconv_bf16` up to summation order. cuDNN's forward
    convs repeat their bits from run to run, where its backward-data pass
    (``conv_transpose2d``) sums fp32 with atomics, so a decode repeats its
    bits without ``torch.backends.cudnn.deterministic``, which belongs to
    the whole process.
    """
    if tuple(w5.shape[2:]) != (5, 5):
        raise ValueError(f"expected a 5 x 5 kernel, got {tuple(w5.shape)}.")
    out = _run_conv(F.conv2d, y.permute(0, 3, 1, 2), _tconv4_phase_kernel(w5), dtype,
                    out_dtype, round_input=round_input, padding=1)
    return _depth_to_space(out.permute(0, 2, 3, 1), block=2)


def _encode_tail_dtypes(fp32_enc_tail):
    """``(c1_dtype, c1_out, c2_dtype, c2_out, c3_dtype)`` for an encoder
    tail level: from the chosen level on, every conv runs fp32 and the
    GDN between fp32 stages pools and scales in fp32."""
    return (_F32 if fp32_enc_tail >= 3 else _BF16,  # conv_1 operand dtype
            _F32 if fp32_enc_tail >= 2 else _BF16,  # conv_1 output -> GDN_1
            _F32 if fp32_enc_tail >= 2 else _BF16,  # conv_2 operand dtype
            _F32 if fp32_enc_tail >= 1 else _BF16,  # conv_2 output -> GDN_2
            _F32 if fp32_enc_tail >= 1 else _BF16)  # conv_3 operand dtype


def fast_encode(qparams, visible_units, learn_bin_widths=True, use_s2d=True,
                fp32_enc_tail=0):
    """Analysis transform over bf16-rounded or int8-stored weights, NHWC
    in and out.

    ``qparams`` comes from :func:`bf16_weight_params` with the same
    ``fp32_enc_tail``, or from :func:`quantize_params_int8`. ``use_s2d``
    runs the first conv in its space-to-depth form (16 input channels
    instead of 1), else as the plain strided conv. The latents are
    always fp32.
    """
    p = dequantize_int8_params(qparams, names=_ENCODER_KERNELS)
    (c1_dtype, c1_out, c2_dtype, c2_out, c3_dtype) = _encode_tail_dtypes(
        fp32_enc_tail)
    if use_s2d:
        x = _conv1_s2d(visible_units, p["weights_1"], dtype=c1_dtype, out_dtype=c1_out)
    else:
        x = _conv_bf16(visible_units, p["weights_1"], csts.STRIDE_1, out_dtype=c1_out,
                       dtype=c1_dtype)
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


def _decode_tail_dtypes(fp32_tail, fp32_head=False, fp32_igdn6=False, fp32_tconv4=False):
    """``(t4_dtype, t4_out, t5_dtype, t5_out, t6_dtype)`` for a decoder
    tail level: 1 = IGDN_6 + final 9x9 tconv, 2 = + tconv_5, 3 = the
    whole synthesis transform. ``fp32_head`` makes tconv_4's output (and
    so IGDN_5) fp32 at any level; ``fp32_tconv4`` also its operands;
    ``fp32_igdn6`` makes tconv_5's output (and so IGDN_6) fp32 while
    tconv_5 and the final tconv keep bf16 operands."""
    head = fp32_tail >= 3 or fp32_tconv4
    return (_F32 if head else _BF16,             # tconv_4 operand dtype
            _F32 if head or fp32_head else _BF16,  # tconv_4 output -> IGDN_5
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


def _synthesis(p, x, dtypes, use_s2d, exact_latents=False):
    """The synthesis transform from tconv_4 on, in the stage dtypes of
    :func:`_decode_tail_dtypes`; fp32 out."""
    (t4_dtype, t4_out, t5_dtype, t5_out, t6_dtype) = dtypes
    # As a transposed conv, tconv_4 on fp32 operands (which is how it
    # runs for an fp32 result, whatever its kernel's dtype) is cuDNN's
    # backward-data pass at H/16, whose default algorithm sums with
    # atomics: two decodes of the same symbols would differ in the last
    # bits, bf16 roundings downstream carry that to 0.1 of a pixel level,
    # and a captured CUDA graph could not equal its eager run. Its phase
    # form is a forward conv, which repeats its bits, as does tconv_6's
    # depth-to-space form; bf16 tconv_5 repeats its bits as it is, fp32
    # tail levels do not there.
    x = _tconv4_phases(x, p["weights_4"], out_dtype=t4_out, dtype=t4_dtype,
                       round_input=not exact_latents)
    x = x + p["biases_4"].to(t4_out)
    x = gdn_nhwc(x, p["gamma_5"], p["beta_5"], inverse=True)
    x = _tconv_bf16(x, p["weights_5"], csts.STRIDE_2, out_dtype=t5_out,
                    dtype=t5_dtype)
    x = x + p["biases_5"].to(t5_out)
    x = gdn_nhwc(x, p["gamma_6"], p["beta_6"], inverse=True)
    if use_s2d:
        x = _tconv6_s2d(x, p["weights_6"], dtype=t6_dtype)
    else:
        x = _tconv_bf16(x, p["weights_6"], csts.STRIDE_1, dtype=t6_dtype)
    return x.to(_F32)


def fast_decode(qparams, latents, use_s2d=True, fp32_tail=0, fp32_head=False,
                exact_latents=False, fp32_igdn6=False, fp32_tconv4=False):
    """Synthesis transform over bf16-rounded or int8-stored weights, NHWC
    in and out.

    Learned-bin-width architecture. ``latents`` are either the
    dequantised, mean-restored latents (the pipeline passes
    ``sym * bw + mean``) with ``qparams`` of the unfolded parameters, or
    raw integer symbols with ``qparams`` of
    ``fold_bin_widths_into_decoder(...)``, the reference's
    ``fast_decode`` (the symbols are centred: that call adds no map
    means). ``qparams`` comes from :func:`bf16_weight_params` with the
    same ``fp32_tail`` and ``fp32_tconv4``, or from
    :func:`quantize_params_int8`. ``use_s2d`` runs the last transposed
    conv in its depth-to-space form, else as the plain strided one.

    ``fp32_head`` keeps tconv_4's output and IGDN_5 fp32;
    ``exact_latents`` (needs ``fp32_head``) leaves tconv_4's input
    unrounded; ``fp32_tconv4`` runs tconv_4 on fp32 operands, kernel
    included; ``fp32_igdn6`` keeps tconv_5's output and IGDN_6 fp32 (see
    ``BF16WPLUS_*``). The reconstruction is fp32.
    """
    p = dequantize_int8_params(qparams, names=_DECODER_KERNELS)
    dtypes = _decode_tail_dtypes(fp32_tail, fp32_head, fp32_igdn6, fp32_tconv4)
    return _synthesis(p, latents.to(_F32), dtypes, use_s2d, exact_latents)


def fast_decode_fixed_bw(qparams, symbols, bin_widths, use_s2d=True, fp32_tail=0,
                         fp32_head=False, fp32_igdn6=False):
    """Synthesis transform of the fixed-bin-width architecture, from
    integer symbols.

    IGDN_4 sits between the symbols and the first transposed conv and is
    not linear, so the dequantiser cannot fold into the kernel: it runs
    inline, ``symbols * bin_widths`` into IGDN_4 in fp32, then the stages
    of :func:`fast_decode` with the same knobs. At tail 0 the three IGDN
    sites launch the fp32 kernel at the bottleneck and the bf16 kernel
    twice.
    """
    p = dequantize_int8_params(qparams, names=_DECODER_KERNELS)
    dtypes = _decode_tail_dtypes(fp32_tail, fp32_head, fp32_igdn6)
    bin_widths = torch.as_tensor(bin_widths, dtype=_F32, device=symbols.device)
    x = gdn_nhwc(symbols.to(_F32) * bin_widths, p["gamma_4"], p["beta_4"], inverse=True)
    return _synthesis(p, x, dtypes, use_s2d)


def scan_params(params, bin_widths, store="bf16", **knobs):
    """``(qparams, qparams_folded)`` for :func:`fast_roundtrip_scan` with
    these ``knobs``: the dequantiser folded into the decoder in fp32
    first, then the store chosen ("bf16": kernels rounded to bf16 but
    those the knobs keep fp32; "int8")."""
    folded = fold_bin_widths_into_decoder(params, bin_widths)
    if store == "int8":
        return (quantize_params_int8(params), quantize_params_int8(folded))
    if store != "bf16":
        raise ValueError(f"unknown store {store!r} (use 'bf16' or 'int8').")
    return (bf16_weight_params(params, fp32_enc_tail=knobs.get("fp32_enc_tail", 0)),
            bf16_weight_params(folded, fp32_tail=knobs.get("fp32_tail", 0),
                               fp32_tconv4=knobs.get("fp32_tconv4", False)))


def scan_variant(params, bin_widths, variant):
    """``(qparams, qparams_folded, knobs)`` of one serving variant for
    :func:`fast_roundtrip_scan`: "int8" and "bf16w" as the reference runs
    them (all bf16), "bf16w+" with ``BF16WPLUS_SCAN_MIX``."""
    if variant not in SCAN_VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use 'bf16w+', 'bf16w' or 'int8').")
    (store, knobs) = SCAN_VARIANTS[variant]
    return (*scan_params(params, bin_widths, store, **knobs), dict(knobs))


def _roundtrip(qparams, qparams_folded, batch, bin_widths, use_s2d, fp32_enc_tail, decode_knobs):
    """One batch of :func:`fast_roundtrip_scan`: ``(reconstruction, symbols)``."""
    y = fast_encode(qparams, batch, learn_bin_widths=True, use_s2d=use_s2d,
                    fp32_enc_tail=fp32_enc_tail)
    symbols = torch.round(y / bin_widths)
    return (fast_decode(qparams_folded, symbols, use_s2d=use_s2d, **decode_knobs), symbols)


class _ScanGraph:
    """The K-batch round trip captured once into a ``torch.cuda.CUDAGraph``
    over a static input and static outputs. Holds the tensors the graph
    reads, so their addresses stay theirs while it lives."""

    def __init__(self, body, stacked_batches, held):
        self.held = held
        self.stacked = stacked_batches.clone()
        # cuDNN chooses its plans, the kernels' library loads and their
        # attributes are set at a first use, none of which a capture
        # allows: run one batch eagerly first.
        body(self.stacked[0])
        torch.cuda.synchronize(self.stacked.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            outputs = [body(self.stacked[k]) for k in range(self.stacked.shape[0])]
            self.reconstructions = torch.stack([rec for (rec, _) in outputs])
            self.symbols = torch.stack([sym for (_, sym) in outputs])

    def __call__(self, stacked_batches):
        self.stacked.copy_(stacked_batches)
        self.graph.replay()
        # Copies: the next replay writes the static outputs again.
        return (self.reconstructions.clone(), self.symbols.clone())


_scan_graphs = {}


def clear_scan_graphs():
    """Drops the captured graphs of :func:`fast_roundtrip_scan` with
    their static buffers and private memory pools."""
    _scan_graphs.clear()


def _leaves(qparams):
    """The tensors of a parameter dict, an int8 entry's two included."""
    for (_, value) in sorted(qparams.items()):
        yield from (value.values() if isinstance(value, dict) else (value,))


def fast_roundtrip_scan(qparams, qparams_folded, stacked_batches, bin_widths, use_s2d=True,
                        fp32_tail=0, fp32_enc_tail=0, fp32_head=False, fp32_igdn6=False,
                        fp32_tconv4=False, graph=False):
    """Encode + quantise + decode K batches as one program.

    ``stacked_batches`` is ``(K, B, H, W, 1)`` fp32; returns
    ``(reconstructions, symbols)`` stacked the same way, the symbols
    ``round(y / bin_widths)`` as fp32 integers (no map means).
    Learned-bin-width architecture: ``qparams_folded`` holds the bin
    widths in its first decoder kernel (:func:`scan_variant` makes both
    dicts and the knobs of a variant).

    Eagerly it is a loop over the K batches, on any device. With
    ``graph=True`` (card only; raises on the CPU) the loop is captured
    once per (shapes, dtypes, knobs, parameter tensors) into a CUDA graph
    and replayed: the same kernels on the same numbers with no host work
    between them. The graph reads the parameter tensors and
    ``bin_widths`` at their addresses, so pass the same tensors (on the
    card) again to hit the capture; the captures live until
    :func:`clear_scan_graphs`. The GDN wrappers count their launches
    where Python calls them: at the warm-up batch and the capture, not
    at a replay.
    """
    decode_knobs = dict(fp32_tail=fp32_tail, fp32_head=fp32_head, fp32_igdn6=fp32_igdn6,
                        fp32_tconv4=fp32_tconv4)
    if not graph:
        bin_widths = torch.as_tensor(bin_widths, dtype=_F32, device=stacked_batches.device)

    def body(batch):
        return _roundtrip(qparams, qparams_folded, batch, bin_widths, use_s2d,
                          fp32_enc_tail, decode_knobs)

    if not graph:
        outputs = [body(batch) for batch in stacked_batches]
        return (torch.stack([rec for (rec, _) in outputs]),
                torch.stack([sym for (_, sym) in outputs]))
    if stacked_batches.device.type != "cuda":
        raise RuntimeError("fast_roundtrip_scan(graph=True) captures a CUDA graph and needs "
                           f"its batches on the card, not on {stacked_batches.device}; "
                           "graph=False runs the same program eagerly.")
    if not torch.is_tensor(bin_widths) or bin_widths.device != stacked_batches.device:
        raise ValueError("graph=True needs bin_widths as a tensor on the batches' device: "
                         "the graph reads it at its address.")
    held = [*_leaves(qparams), *_leaves(qparams_folded), bin_widths]
    key = (tuple(stacked_batches.shape), stacked_batches.dtype, stacked_batches.device,
           use_s2d, fp32_enc_tail, tuple(sorted(decode_knobs.items())),
           tuple((leaf.data_ptr(), tuple(leaf.shape), leaf.dtype) for leaf in held))
    if key not in _scan_graphs:
        _scan_graphs[key] = _ScanGraph(body, stacked_batches, held)
    return _scan_graphs[key](stacked_batches)
