"""Height-sharded transforms: each shard holds a band of image rows.

The reference shards the image height over the ``model`` axis and lets
GSPMD insert the exchanges (``parallel/inference.py``,
``P("data", "model", None, None)``). Here they are written out. A data
block's image is cut into ``M`` bands of equal height, a multiple of 16
(the total stride), one band a shard; every layer keeps the bands
aligned with its stride, so band ``m`` of a layer's output is exactly
the rows that band ``m`` of its input produces.

- Before each strided conv, a band takes from its neighbours the rows
  the conv's TF-SAME window reaches across the cut: ``same_pads`` gives
  ``(2, 3)`` for the 9x9 stride-4 conv and ``(1, 2)`` for the 5x5
  stride-2 convs (rows above, rows below). Only the bands at the image's
  edges are zero-padded, as the whole image is.
- A transposed conv scatters each input row into ``k`` output rows, so
  a band's output rows also receive from its neighbours' input rows:
  the band takes one input row from each side (:func:`tconv_halo`),
  computes the transposed conv of the extended band and keeps its own
  output rows. Each output element sums the same input rows as on the
  whole image.
- GDN, IGDN and the fused GDN+quantise are per pixel: each band runs
  them on its own rows through the kernels.

The exchange is one function, :class:`HaloExchange`: between bands held
by one process it slices; between processes it sends and receives over
``torch.distributed`` (point to point, the neighbours only).
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models.conv_eae import same_pads
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_nhwc,
    gdn_quantize_nhwc,
)
from autoencoder_based_image_compression_tpu_torch.ops.quantization import quantize_per_map
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32


def tconv_halo(kernel, stride):
    """Input rows ``(above, below)`` a band's transposed conv needs from
    its neighbours: 1 and 1 for both the 9/4 and the 5/2 kernels."""
    (lo, _) = same_pads(kernel, stride)
    return ((kernel - 1 - lo) // stride, (lo - 1) // stride + 1)


class HaloExchange:
    """Rows across the cuts between the bands of data block ``d``.

    ``exchange(bands, above, below)`` takes ``{m: band}`` of the bands
    this process holds (NHWC) and returns ``{m: (rows_above,
    rows_below)}``: the last ``above`` rows of band ``m - 1`` and the
    first ``below`` rows of band ``m + 1``, zeros beyond the image's
    edges. A neighbour in another process sends its rows, and is sent
    this band's, point to point.
    """

    def __init__(self, mesh, d):
        self.mesh = mesh
        self.d = d
        self.nb_bands = mesh.size("model")

    def _rank(self, m):
        return self.mesh.entry_rank(self.d, m)

    def __call__(self, bands, above, below):
        here = self.mesh.rank
        (requests, received, sent) = ([], {}, [])
        for (m, band) in bands.items():
            if band.shape[1] < max(above, below):
                raise ValueError(f"a band of {band.shape[1]} rows cannot lend {above} / "
                                 f"{below} rows: cut the image into fewer bands.")
            for (other, rows, tag) in ((m - 1, band[:, :below], 1),
                                       (m + 1, band[:, band.shape[1] - above:], 0)):
                if 0 <= other < self.nb_bands and other not in bands:
                    if self._rank(other) == here:
                        raise ValueError(f"band {other} is held here but was not passed.")
                    sent.append(rows.contiguous())
                    requests.append(dist.isend(sent[-1], self._rank(other), tag=tag))
            for (other, nb_rows, tag) in ((m - 1, above, 0), (m + 1, below, 1)):
                if 0 <= other < self.nb_bands and other not in bands:
                    buffer = torch.empty((band.shape[0], nb_rows) + tuple(band.shape[2:]),
                                         dtype=band.dtype, device=band.device)
                    requests.append(dist.irecv(buffer, self._rank(other), tag=tag))
                    received[(m, other)] = buffer
        for request in requests:
            request.wait()
        halos = {}
        for (m, band) in bands.items():
            def rows(other, nb_rows, first):
                if not 0 <= other < self.nb_bands:
                    return band.new_zeros((band.shape[0], nb_rows) + tuple(band.shape[2:]))
                if other in bands:
                    source = bands[other]
                    part = source[:, :nb_rows] if first else source[:, source.shape[1] - nb_rows:]
                    return part.to(band.device)
                return received[(m, other)]
            halos[m] = (rows(m - 1, above, False), rows(m + 1, below, True))
        return halos


def _on(tensor, like):
    return tensor.to(like.device)


def conv_same_bands(bands, w, stride, exchange):
    """:func:`models.conv_eae.conv_same` on each band, with its halo."""
    (lo, hi) = same_pads(w.shape[-1], stride)
    halos = exchange(bands, lo, hi)
    out = {}
    for (m, x) in bands.items():
        (top, bottom) = halos[m]
        extended = torch.cat([top, x, bottom], dim=1).permute(0, 3, 1, 2)
        out[m] = F.conv2d(F.pad(extended, (lo, hi, 0, 0)), _on(w, x),
                          stride=stride).permute(0, 2, 3, 1)
    return out


def conv_transpose_same_bands(bands, w, stride, exchange):
    """:func:`models.conv_eae.conv_transpose_same` on each band: the
    transposed conv of the band extended by :func:`tconv_halo` rows,
    cropped to the band's own output rows."""
    kernel = w.shape[-1]
    (lo, _) = same_pads(kernel, stride)
    (above, below) = tconv_halo(kernel, stride)
    halos = exchange(bands, above, below)
    out = {}
    for (m, y) in bands.items():
        (top, bottom) = halos[m]
        (height, width) = (y.shape[1], y.shape[2])
        extended = torch.cat([top, y, bottom], dim=1).permute(0, 3, 1, 2)
        full = F.conv_transpose2d(extended, _on(w, y), stride=stride)
        start = stride * above + lo
        out[m] = full[:, :, start:start + stride * height,
                      lo:lo + stride * width].permute(0, 2, 3, 1)
    return out


def _gdn(bands, params, index, inverse=False):
    return {m: gdn_nhwc(x, _on(params[f"gamma_{index}"], x), _on(params[f"beta_{index}"], x),
                        inverse=inverse) for (m, x) in bands.items()}


def _bias(bands, bias):
    return {m: x + _on(bias, x) for (m, x) in bands.items()}


def analysis_bands(params, bands, exchange):
    """The analysis transform up to the latent conv (before GDN_3),
    band by band: ``{m: (B, h, W, 1)}`` -> ``{m: (B, h/16, W/16, 128)}``."""
    disable_tf32()
    x = _bias(conv_same_bands(bands, params["weights_1"], csts.STRIDE_1, exchange),
              params["biases_1"])
    x = _gdn(x, params, 1)
    x = _bias(conv_same_bands(x, params["weights_2"], csts.STRIDE_2, exchange),
              params["biases_2"])
    x = _gdn(x, params, 2)
    return _bias(conv_same_bands(x, params["weights_3"], csts.STRIDE_3, exchange),
                 params["biases_3"])


def encode_bands(params, bands, learn_bin_widths, exchange):
    """:func:`models.conv_eae.encode`, band by band."""
    x = analysis_bands(params, bands, exchange)
    return x if learn_bin_widths else _gdn(x, params, 3)


def quantize_bands(params, bands, bin_widths, learn_bin_widths, exchange):
    """Encode and quantise, band by band. In the fixed-bin-width
    architecture GDN_3 and the quantiser are one launch of the fused
    GDN+quantise kernel a band."""
    x = analysis_bands(params, bands, exchange)
    if learn_bin_widths:
        return {m: quantize_per_map(v, _on(bin_widths, v)) for (m, v) in x.items()}
    return {m: gdn_quantize_nhwc(v, _on(params["gamma_3"], v), _on(params["beta_3"], v),
                                 _on(bin_widths, v)) for (m, v) in x.items()}


def decode_bands(params, bands, learn_bin_widths, exchange):
    """:func:`models.conv_eae.decode`, band by band."""
    disable_tf32()
    x = bands if learn_bin_widths else _gdn(bands, params, 4, inverse=True)
    x = _bias(conv_transpose_same_bands(x, params["weights_4"], csts.STRIDE_3, exchange),
              params["biases_4"])
    x = _gdn(x, params, 5, inverse=True)
    x = _bias(conv_transpose_same_bands(x, params["weights_5"], csts.STRIDE_2, exchange),
              params["biases_5"])
    x = _gdn(x, params, 6, inverse=True)
    return conv_transpose_same_bands(x, params["weights_6"], csts.STRIDE_1, exchange)
