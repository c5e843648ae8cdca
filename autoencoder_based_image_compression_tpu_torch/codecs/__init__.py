"""Anchor codecs driven as subprocesses: JPEG, JPEG2000, HEVC.

The reference benchmarks its learned codec against external codecs
invoked across a process + filesystem boundary (SURVEY.md L5); these
wrappers keep that design and are gated on binary availability
(ImageMagick, HM TAppEncoderStatic) - absent binaries raise
:class:`CodecUnavailableError` instead of failing mid-sweep.
"""

from autoencoder_based_image_compression_tpu_torch.codecs.common import CodecUnavailableError
