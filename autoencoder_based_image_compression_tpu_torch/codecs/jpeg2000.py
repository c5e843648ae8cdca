"""JPEG2000 anchor.

Reference ``kodak_tensorflow/jpeg2000/jpeg2000.py:50-291`` shells out to
ImageMagick and reads back via glymur; here the default backend is
Pillow's bundled OpenJPEG (no subprocess, no temp files), with
ImageMagick kept as an alternative backend for environments that have
it. Rate = 8 * coded_bytes / pixels, PSNR on the decoded round trip -
the same accounting as the reference (``jpeg2000.py:120-122``). PIL is
imported where an image is coded, so importing this module does not
need it.

The sweep parameter is the target compression ratio (``quality_layers``)
rather than ImageMagick's opaque ``-quality`` scale; both trace out the
codec's RD curve.
"""

import io
import os
import subprocess
import tempfile

import numpy

from autoencoder_based_image_compression_tpu_torch.codecs.common import (
    CodecUnavailableError,
    find_imagemagick,
)
from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu_torch.utils.image import read_image_mode, save_image

# Compression ratios sweeping the reference's operating range
# (~0.1 - 1.2 bpp on 8-bit luminance) - the Pillow-backend ladder -
# extended toward lower quality (ratios up to 600) so the anchor's PSNR
# range reaches down to overlap learned-codec curves and the
# Bjontegaard summary is computable.
DEFAULT_RATIOS = (600, 400, 300, 220, 160, 120, 80, 64, 48, 32, 24, 16, 12, 8)

# The reference's ImageMagick -quality ladder
# (reconstructing_eae_kodak.py:653).
REFERENCE_QUALITIES = (24, 26, 28, 30, 32, 34, 36, 38, 40)


def imagemagick_available():
    """True when the ImageMagick CLI is on PATH."""
    try:
        find_imagemagick()
        return True
    except CodecUnavailableError:
        return False


def compress_jpeg2000(luminance_uint8, ratio):
    """One image at one target compression ratio via Pillow/OpenJPEG.

    Returns ``(rate_bpp, reconstruction_uint8)``.
    """
    import PIL.Image

    image = PIL.Image.fromarray(luminance_uint8)
    buffer = io.BytesIO()
    image.save(buffer, "JPEG2000", quality_mode="rates", quality_layers=[ratio],
               irreversible=True)
    coded = buffer.getvalue()
    rate = 8.0 * len(coded) / luminance_uint8.size
    reconstruction = numpy.asarray(PIL.Image.open(io.BytesIO(coded)))
    return (rate, reconstruction)


def compress_jpeg2000_imagemagick(luminance_uint8, quality, work_dir):
    """ImageMagick backend (the reference's path), kept for parity runs."""
    magick = find_imagemagick()
    path_png = os.path.join(work_dir, "in.png")
    path_jp2 = os.path.join(work_dir, "out.jp2")
    path_back = os.path.join(work_dir, "back.png")
    save_image(path_png, luminance_uint8)
    subprocess.check_call([magick, path_png, "-quality", str(quality), path_jp2],
                          stderr=subprocess.DEVNULL)
    rate = 8.0 * os.path.getsize(path_jp2) / luminance_uint8.size
    subprocess.check_call([magick, path_jp2, path_back], stderr=subprocess.DEVNULL)
    return (rate, read_image_mode(path_back, "L"))


def evaluate_jpeg2000(luminances_uint8, ratios=None, backend="auto"):
    """Sweep over an image stack.

    Returns ``(rates, psnrs)`` of shape (nb_images, nb_points)
    (reference ``jpeg2000.py:201-291``).

    ``backend="auto"`` (default) uses ImageMagick with the reference's
    quality ladder {24..40} when the CLI is installed - the
    anchor-fidelity path - and falls back to Pillow/OpenJPEG at the
    ratio ladder otherwise. Explicit ``ratios`` override either ladder.
    """
    if backend == "auto":
        backend = "imagemagick" if imagemagick_available() else "pillow"
    if ratios is None:
        ratios = REFERENCE_QUALITIES if backend == "imagemagick" else DEFAULT_RATIOS
    nb_images = luminances_uint8.shape[0]
    rates = numpy.zeros((nb_images, len(ratios)))
    psnrs = numpy.zeros((nb_images, len(ratios)))
    if backend == "pillow":
        for i in range(nb_images):
            luminance = luminances_uint8[i]
            if luminance.ndim == 3:
                luminance = luminance[:, :, 0]
            for (j, ratio) in enumerate(ratios):
                (rates[i, j], reconstruction) = compress_jpeg2000(luminance, ratio)
                psnrs[i, j] = psnr_2d(luminance, reconstruction)
    else:
        with tempfile.TemporaryDirectory() as work_dir:
            for i in range(nb_images):
                luminance = luminances_uint8[i]
                if luminance.ndim == 3:
                    luminance = luminance[:, :, 0]
                for (j, quality) in enumerate(ratios):
                    (rates[i, j], reconstruction) = compress_jpeg2000_imagemagick(
                        luminance, quality, work_dir)
                    psnrs[i, j] = psnr_2d(luminance, reconstruction)
    return (rates, psnrs)
