"""JPEG / JPEG2000 anchors for RGB digits (the SVHN comparison).

Reference ``svhn/jpeg/jpeg.py:75-303`` (ImageMagick quality sweep on
32x32 RGB digits); default backend here is Pillow (libjpeg/OpenJPEG
in-process), rate from the coded byte count, PSNR over the RGB round
trip.
"""

import io

import numpy


def _psnr_rgb(reference_uint8, reconstruction_uint8):
    mse = numpy.mean((reference_uint8.astype(numpy.float64)
                      - reconstruction_uint8.astype(numpy.float64)) ** 2)
    if mse == 0.0:
        raise ValueError("The mean squared error is 0.")
    return 10.0 * numpy.log10((255.0 ** 2) / mse)


def compress_rgb(rgb_uint8, quality, codec="jpeg"):
    """One RGB image through Pillow at one quality setting.

    ``codec``: "jpeg" (quality 1-95) or "jpeg2000" (target compression
    ratio). Returns ``(rate_bpp, reconstruction_uint8)`` with all three
    channels charged to the pixel budget like the reference.
    """
    import PIL.Image

    image = PIL.Image.fromarray(rgb_uint8)
    buffer = io.BytesIO()
    if codec == "jpeg":
        image.save(buffer, "JPEG", quality=int(quality))
    elif codec == "jpeg2000":
        image.save(buffer, "JPEG2000", quality_mode="rates",
                   quality_layers=[quality], irreversible=True)
    else:
        raise ValueError(codec)
    coded = buffer.getvalue()
    rate = 8.0 * len(coded) / (rgb_uint8.shape[0] * rgb_uint8.shape[1])
    reconstruction = numpy.asarray(
        PIL.Image.open(io.BytesIO(coded)).convert("RGB"))
    return (rate, reconstruction)


def evaluate_jpeg(rows_uint8, qualities, codec="jpeg"):
    """Quality sweep over flattened (N, 3072) digit rows.

    Returns mean ``(rates, psnrs)`` per quality (reference
    ``svhn/jpeg/jpeg.py:191-303``).
    """
    nb_images = rows_uint8.shape[0]
    rates = numpy.zeros((nb_images, len(qualities)))
    psnrs = numpy.zeros((nb_images, len(qualities)))
    for i in range(nb_images):
        rgb = rows_uint8[i].reshape(32, 32, 3)
        for (j, quality) in enumerate(qualities):
            (rates[i, j], reconstruction) = compress_rgb(rgb, quality, codec)
            psnrs[i, j] = _psnr_rgb(rgb, reconstruction)
    return (numpy.mean(rates, axis=0), numpy.mean(psnrs, axis=0))
