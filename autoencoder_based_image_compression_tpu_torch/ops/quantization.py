"""Uniform scalar quantisation and the output casts.

Counterparts of the reference's ``tools/tools.py:883-929``
(``quantize_per_map``), ``:61-93`` (``cast_bt601``) and ``:95-155``
(``cast_float_to_int16``). ``torch.round`` rounds half to even, like
``jnp.round`` and ``numpy.round``.
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


def cast_bt601(array_float):
    """Clips to the BT.601 luminance range [16, 235], rounds, casts to
    uint8. Accepts a numpy array or a tensor and returns the same kind."""
    if isinstance(array_float, numpy.ndarray):
        return numpy.round(array_float.clip(16.0, 235.0)).astype(numpy.uint8)
    return torch.round(array_float.clamp(16.0, 235.0)).to(torch.uint8)


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
