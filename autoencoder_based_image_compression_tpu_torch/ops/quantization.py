"""Uniform scalar quantisation and the output casts.

Counterparts of the reference's ``tools/tools.py:883-929``
(``quantize_per_map``), ``:61-93`` (``cast_bt601``; ``cast_uint8`` is its
RGB-range sibling), ``:95-155``
(``cast_float_to_int16``) and ``tfutils/tfutils.py:8-43`` (``add_noise``).
``torch.round`` rounds half to even, like ``jnp.round`` and
``numpy.round``.
"""

import numpy
import torch


def quantize_per_map(data, bin_widths):
    """``out[..., i] = bin_widths[i] * round(data[..., i] / bin_widths[i])``.

    ``data`` is a tensor of shape ``(..., C)``; ``bin_widths`` has shape
    ``(C,)`` and is strictly positive.
    """
    bw = torch.as_tensor(bin_widths, dtype=data.dtype, device=data.device)
    return bw * torch.round(data / bw)


def add_uniform_noise(noise, data, bin_widths):
    """Adds per-channel zero-mean uniform noise U(-delta_i/2, delta_i/2):
    the training-time differentiable stand-in for the quantiser.

    ``noise`` is a ``torch.Generator`` on ``data``'s device, from which
    U[-0.5, 0.5) of ``data``'s shape is drawn, or that noise itself as a
    tensor (so that two implementations can be fed the same numbers).
    ``data`` has shape ``(..., C)`` and ``bin_widths`` ``(C,)``.
    """
    if isinstance(noise, torch.Generator):
        noise = torch.rand(data.shape, generator=noise, device=data.device,
                           dtype=data.dtype) - 0.5
    elif noise.shape != data.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for data of shape "
                         f"{tuple(data.shape)}.")
    return data + bin_widths * noise


def cast_bt601(array_float):
    """Clips to the BT.601 luminance range [16, 235], rounds, casts to
    uint8. Accepts a numpy array or a tensor and returns the same kind."""
    if isinstance(array_float, numpy.ndarray):
        return numpy.round(array_float.clip(16.0, 235.0)).astype(numpy.uint8)
    return torch.round(array_float.clamp(16.0, 235.0)).to(torch.uint8)


def cast_uint8(array_float):
    """Clips to [0, 255], rounds (half to even) and casts to uint8 (the
    RGB pixel range). Accepts a numpy array or a tensor and returns the
    same kind."""
    if isinstance(array_float, numpy.ndarray):
        return numpy.round(array_float.clip(0.0, 255.0)).astype(numpy.uint8)
    return torch.round(array_float.clamp(0.0, 255.0)).to(torch.uint8)


def cast_float_to_int16(array_float):
    """Rounds and casts to int16, raising when a value does not fit.

    The rounding corrects floating-point error from a preceding
    division; the guard protects the coder's int16 symbol range (a plain
    cast would wrap).
    """
    rounded = numpy.round(numpy.asarray(array_float))
    if numpy.any(numpy.absolute(rounded) > 32767.0):
        raise AssertionError("The rounded elements do not fit in int16.")
    return rounded.astype(numpy.int16)
