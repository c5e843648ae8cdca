"""Synthetic luminance images for development and on-card smoke runs.

Band-limited noise plus gradients, so the codec sees image-like content
rather than white noise. Same generator and seeds as the reference
package's ``data/synthetic.py``: the two packages see the same images.
"""

import numpy


def synthetic_luminance_stack(nb_images, height, width, seed=0):
    """(N, H, W, 1) uint8 smooth synthetic luminance images."""
    rng = numpy.random.default_rng(seed)
    stack = numpy.zeros((nb_images, height, width, 1), dtype=numpy.uint8)
    (yy, xx) = numpy.meshgrid(numpy.linspace(0, 1, height),
                              numpy.linspace(0, 1, width), indexing="ij")
    for i in range(nb_images):
        # Low-frequency content: random smooth gradients + blurred noise.
        base = (80.0 * rng.random() * xx + 80.0 * rng.random() * yy
                + 40.0 * numpy.sin(2 * numpy.pi * (2 + 3 * rng.random()) * xx
                                   + 2 * numpy.pi * rng.random()))
        noise = rng.normal(0.0, 1.0, size=(height, width))
        for _ in range(3):  # cheap separable blur
            noise = 0.25 * (numpy.roll(noise, 1, 0) + numpy.roll(noise, -1, 0)
                            + numpy.roll(noise, 1, 1) + numpy.roll(noise, -1, 1))
        image = 60.0 + base + 25.0 * noise
        stack[i, :, :, 0] = numpy.round(image.clip(16.0, 235.0)).astype(numpy.uint8)
    return stack


def synthetic_kodak(seed=0):
    """24 Kodak-shaped (512x768) synthetic luminance images."""
    return synthetic_luminance_stack(24, 512, 768, seed)
