"""Shared helpers for the subprocess codec wrappers."""

import shutil


class CodecUnavailableError(RuntimeError):
    """Raised when the external codec binary is not installed."""


def find_imagemagick():
    """Returns the ImageMagick convert command or raises."""
    for candidate in ("magick", "convert"):
        path = shutil.which(candidate)
        if path is not None:
            return candidate
    raise CodecUnavailableError(
        "ImageMagick ('magick' or 'convert') is not on PATH; the "
        "JPEG/JPEG2000 anchors need it.")
