"""Seeded synthetic luminance images, made on the device.

A torch rewrite of the port's ``data/synthetic.py::synthetic_luminance_stack``
(smooth gradients, a sine, blurred noise; clipped to the BT.601 range),
so that a run's images come from ``--seed`` in a few large calls on the
card. One change: each image's four shape parameters are stratified
over the stack (each parameter takes one value in each of the N equal
strata of [0, 1), in a seeded order), so every seed draws the same
spread of content and the coder's work does not swing with the seed.
"""

import math

import torch


def luminance_stack(nb_images, height, width, generator, device, chunk=256):
    """``(nb_images, height, width, 1)`` uint8 images on ``device``, drawn
    from ``generator`` (a ``torch.Generator`` on ``device``)."""
    strata = torch.argsort(torch.rand((4, nb_images), generator=generator, device=device),
                           dim=1).to(torch.float32)
    jitter = torch.rand((4, nb_images), generator=generator, device=device)
    (slope_x, slope_y, frequency, phase) = ((strata + jitter) / nb_images)[:, :, None, None]
    yy = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    images = torch.empty((nb_images, height, width, 1), dtype=torch.uint8, device=device)
    for start in range(0, nb_images, chunk):
        part = slice(start, min(start + chunk, nb_images))
        base = (80.0 * slope_x[part] * xx + 80.0 * slope_y[part] * yy
                + 40.0 * torch.sin(2.0 * math.pi * (2.0 + 3.0 * frequency[part]) * xx
                                   + 2.0 * math.pi * phase[part]))
        noise = torch.randn((part.stop - part.start, height, width), generator=generator,
                            device=device)
        for _ in range(3):  # cheap separable blur, periodic at the borders
            noise = 0.25 * (torch.roll(noise, 1, 1) + torch.roll(noise, -1, 1)
                            + torch.roll(noise, 1, 2) + torch.roll(noise, -1, 2))
        image = 60.0 + base + 25.0 * noise
        images[part, :, :, 0] = torch.round(image.clamp(16.0, 235.0)).to(torch.uint8)
    return images
