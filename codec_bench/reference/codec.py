"""The codec's transforms and quantiser, plain PyTorch in fp32.

Layers (the paper's Figure 1; ``kodak_tensorflow/eae/graph``):

    analysis:  conv 9x9/4 -> GDN -> conv 5x5/2 -> GDN -> conv 5x5/2 [-> GDN_3]
    synthesis: [IGDN_4 ->] tconv 5x5/2 -> IGDN -> tconv 5x5/2 -> IGDN -> tconv 9x9/4

with 128 maps everywhere, TensorFlow's "SAME" padding, and

    GDN(x)_c  = x_c / sqrt(beta_c + sum_k gamma[k, c] x_k^2)
    IGDN(x)_c = x_c * sqrt(beta_c + sum_k gamma[k, c] x_k^2)

The bracketed pair exists only with fixed bin widths. Tensors are NCHW
here. Served symbols are ``round((y - map_mean) / bin_width)`` per map;
the decoder takes ``symbol * bin_width + map_mean``.
"""

import os
import pickle

import numpy
import torch
import torch.nn.functional as F

from codec_bench.reference import plain_fp32

STRIDES = {"weights_1": 4, "weights_2": 2, "weights_3": 2, "weights_4": 2, "weights_5": 2,
           "weights_6": 4}


def load_params(path_npz, device):
    """The parameters of a committed ``params_trained.npz`` as fp32 tensors
    on ``device``, with the bin widths.

    Kernels are stored HWIO (``(kh, kw, in, out)`` of a forward conv; a
    decoder kernel is the forward conv it transposes, so its ``in`` is
    the transposed conv's output). ``(3, 2, 0, 1)`` makes an encoder
    kernel ``conv2d``'s ``(out, in, kh, kw)`` and a decoder kernel
    ``conv_transpose2d``'s ``(in, out, kh, kw)``."""
    with numpy.load(path_npz) as data:
        raw = {key.split(":", 1)[1]: numpy.array(data[key], dtype=numpy.float32)
               for key in data.files if key.startswith("param:")}
        bin_widths = numpy.array(data["bin_widths"], dtype=numpy.float32)
    params = {}
    for (name, value) in raw.items():
        tensor = torch.from_numpy(value)
        if name.startswith("weights_"):
            tensor = tensor.permute(3, 2, 0, 1)
        params[name] = tensor.contiguous().to(device)
    return (params, torch.from_numpy(bin_widths).to(device))


def load_statistics(exp_dir, multiplier="1"):
    """``(map_mean, binary_probabilities, idx_map_exception)`` of an
    experiment's ``statistics/`` at a bin-width multiplier's file name."""
    stats = os.path.join(exp_dir, "statistics")
    map_mean = numpy.load(os.path.join(stats, "map_mean.npy")).astype(numpy.float32)
    probabilities = numpy.load(os.path.join(stats, f"binary_probabilities_{multiplier}.npy"))
    with open(os.path.join(stats, "idx_map_exception.pkl"), "rb") as file:
        idx_exception = int(pickle.load(file))
    return (map_mean, probabilities.astype(numpy.float64), idx_exception)


def _pads(kernel, stride):
    """TF 'SAME' pads (before, after) for inputs that the stride divides."""
    total = kernel - stride
    return (total // 2, total - total // 2)


def conv(x, w, stride):
    (lo, hi) = _pads(w.shape[-1], stride)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride)


def tconv(x, w, stride):
    """The adjoint of :func:`conv`: the full transposed conv cropped to
    ``stride`` times the input."""
    (lo, _) = _pads(w.shape[-1], stride)
    full = F.conv_transpose2d(x, w, stride=stride)
    return full[:, :, lo:lo + stride * x.shape[2], lo:lo + stride * x.shape[3]]


def gdn(x, gamma, beta, inverse=False):
    pool = torch.einsum("bkhw,kc->bchw", x * x, gamma) + beta[None, :, None, None]
    return x * torch.sqrt(pool) if inverse else x / torch.sqrt(pool)


def has_bottleneck(params):
    """Fixed bin widths: the GDN_3 / IGDN_4 pair wraps the bottleneck."""
    return "gamma_3" in params


def encode(params, images):
    """``(B, 1, H, W)`` float images -> ``(B, 128, H/16, W/16)`` latents."""
    p = params
    x = conv(images, p["weights_1"], 4) + p["biases_1"][:, None, None]
    x = gdn(x, p["gamma_1"], p["beta_1"])
    x = conv(x, p["weights_2"], 2) + p["biases_2"][:, None, None]
    x = gdn(x, p["gamma_2"], p["beta_2"])
    x = conv(x, p["weights_3"], 2) + p["biases_3"][:, None, None]
    if has_bottleneck(p):
        x = gdn(x, p["gamma_3"], p["beta_3"])
    return x


def decode(params, latents):
    """``(B, 128, h, w)`` latents -> ``(B, 1, 16 h, 16 w)`` reconstruction."""
    p = params
    x = latents
    if has_bottleneck(p):
        x = gdn(x, p["gamma_4"], p["beta_4"], inverse=True)
    x = tconv(x, p["weights_4"], 2) + p["biases_4"][:, None, None]
    x = gdn(x, p["gamma_5"], p["beta_5"], inverse=True)
    x = tconv(x, p["weights_5"], 2) + p["biases_5"][:, None, None]
    x = gdn(x, p["gamma_6"], p["beta_6"], inverse=True)
    return tconv(x, p["weights_6"], 4)


def cast_bt601(x):
    """Clip to [16, 235], round half to even, uint8."""
    return torch.round(x.clamp(16.0, 235.0)).to(torch.uint8)


@torch.no_grad()
def roundtrip(params, bin_widths, map_mean, images_uint8, batch_size=4, dtype=torch.float32):
    """Symbols and reconstructions of ``(N, H, W, 1)`` uint8 images.

    Returns ``(symbols, reconstructions)``: int64 ``(N, H/16, W/16,
    128)`` and uint8 ``(N, H, W, 1)``, numpy. ``dtype`` bfloat16 runs the
    transforms in bf16 (the control of a configuration served in fp32).
    """
    plain_fp32()
    device = bin_widths.device
    p = {name: value.to(dtype) for (name, value) in params.items()}
    mean = torch.as_tensor(map_mean, device=device)[None, :, None, None]
    bw = bin_widths[None, :, None, None]
    (symbols, recs) = ([], [])
    for start in range(0, images_uint8.shape[0], batch_size):
        batch = torch.as_tensor(images_uint8[start:start + batch_size], device=device)
        x = batch.permute(0, 3, 1, 2).to(torch.float32)
        y = encode(p, x.to(dtype)).to(torch.float32)
        sym = torch.round((y - mean) / bw)
        rec = decode(p, (sym * bw + mean).to(dtype)).to(torch.float32)
        symbols.append(sym.permute(0, 2, 3, 1).to(torch.int64).cpu().numpy())
        recs.append(cast_bt601(rec).permute(0, 2, 3, 1).cpu().numpy())
    return (numpy.concatenate(symbols), numpy.concatenate(recs))


def psnr(reconstruction, original):
    """PSNR in dB of uint8 images against the 255 peak."""
    error = numpy.mean(numpy.square(reconstruction.astype(numpy.float64)
                                    - original.astype(numpy.float64)))
    return 10.0 * numpy.log10(255.0 ** 2 / max(error, 1e-12))
