"""The exact length of the codec's bitstream, from its specification.

Each latent map of an image is coded on its own, symbols in row-major
order (the reference's ``kodak_tensorflow/lossless``):

- UEG0 binarisation of an int16 symbol ``s``: ``|s|`` as a truncated
  unary prefix of at most ``tu`` ones, each decision ``i`` coded by a
  16-bit static-probability binary arithmetic coder with the map's
  zero-probability ``p[i]`` (a closing zero when ``|s| < tu``); when the
  prefix saturates, an Exp-Golomb-0 code of ``|s| - tu`` and the sign go
  raw to a bypass stream; otherwise a non-zero symbol's sign goes raw.
- The arithmetic coder: a decision splits ``[low, high]`` at ``low +
  floor(p0 * (high - low))``, the zero taking the lower part; every
  leading bit that ``low`` and ``high`` share is emitted (each followed
  by the pending E3 bits), and while ``low > 0x3FFF`` and ``high <=
  0xBFFD`` the interval is doubled about its middle with one more E3 bit
  pending; the stream ends with one bit and the pending ones.
- The map the statistics mark as the exception is not coded: it costs
  ``ceil(h * w * H)`` bits, ``H`` the empirical entropy of its symbols.

All streams are advanced together, one symbol position at a time, so
the count is exact and runs at numpy speed.
"""

import math

import numpy

_QUARTER = 0x3FFF
_THREE_QUARTERS = 3 * _QUARTER
_MASK = 0xFFFF
_BIT_LENGTH = numpy.zeros(1 << 16, dtype=numpy.int64)
for _k in range(16):
    _BIT_LENGTH[1 << _k:1 << (_k + 1)] = _k + 1


def arithmetic_bits(symbols, probabilities):
    """Bits of each row's code: ``symbols`` int ``(S, L)`` (a row is one
    map's symbols in coding order), ``probabilities`` float64 ``(S,
    tu)``. Returns int64 ``(S,)``: arithmetic-coded plus bypass bits."""
    magnitudes = numpy.abs(numpy.asarray(symbols, dtype=numpy.int64))
    (nb_streams, length) = magnitudes.shape
    tu = probabilities.shape[1]
    low = numpy.zeros(nb_streams, dtype=numpy.int64)
    high = numpy.full(nb_streams, _MASK, dtype=numpy.int64)
    pending = numpy.zeros(nb_streams, dtype=numpy.int64)
    bits = numpy.zeros(nb_streams, dtype=numpy.int64)
    for position in range(length):
        magnitude = magnitudes[:, position]
        decisions = numpy.minimum(magnitude + 1, tu)
        for i in range(int(decisions.max())):
            rows = numpy.nonzero(decisions > i)[0]
            (lo, hi) = (low[rows], high[rows])
            middle = lo + (probabilities[rows, i] * (hi - lo)).astype(numpy.int64)
            one = magnitude[rows] > i
            lo = numpy.where(one, middle + 1, lo)
            hi = numpy.where(one, hi, middle)
            shift = 16 - _BIT_LENGTH[(lo ^ hi) & _MASK]
            emits = shift > 0
            bits[rows] += numpy.where(emits, shift + pending[rows], 0)
            pend = numpy.where(emits, 0, pending[rows])
            lo = (lo << shift) & _MASK
            hi = ((hi << shift) & _MASK) | ((1 << shift) - 1)
            straddle = (lo > _QUARTER) & (hi <= _THREE_QUARTERS)
            while straddle.any():
                lo = numpy.where(straddle, (lo - _QUARTER - 1) << 1, lo)
                hi = numpy.where(straddle, ((hi - _QUARTER - 1) << 1) | 1, hi)
                pend += straddle
                straddle = (lo > _QUARTER) & (hi <= _THREE_QUARTERS)
            (low[rows], high[rows], pending[rows]) = (lo, hi, pend)
    bits += 2 + pending  # the closing bit and the pending ones, one more among them
    saturated = magnitudes >= tu
    suffix = numpy.where(saturated, magnitudes - tu + 1, 1)
    exp_golomb = 2 * (_BIT_LENGTH[numpy.minimum(suffix, _MASK)] - 1) + 2
    bypass = numpy.where(saturated, exp_golomb, (magnitudes != 0).astype(numpy.int64))
    return bits + bypass.sum(axis=1)


def entropy_bits(symbols):
    """``ceil(n * H)`` of one map's symbols, ``H`` their empirical entropy
    in bits per symbol (frequencies in ascending symbol order)."""
    (_, counts) = numpy.unique(numpy.asarray(symbols).ravel(), return_counts=True)
    frequency = counts.astype(numpy.float64) / numpy.sum(counts)
    entropy = -numpy.sum(frequency * numpy.log2(frequency))
    return int(math.ceil(symbols.size * entropy))


def image_bits(symbols, probabilities, idx_exception):
    """Bits of each image's bitstream: ``symbols`` int ``(N, h, w, C)``,
    ``probabilities`` ``(C, tu)``. Returns int64 ``(N,)``."""
    (nb_images, height, width, nb_maps) = symbols.shape
    coded = [m for m in range(nb_maps) if m != idx_exception]
    rows = numpy.moveaxis(symbols, 3, 1)[:, coded].reshape(nb_images * len(coded),
                                                           height * width)
    probs = numpy.tile(probabilities[coded], (nb_images, 1))
    bits = arithmetic_bits(rows, probs).reshape(nb_images, len(coded)).sum(axis=1)
    if 0 <= idx_exception < nb_maps:
        bits += numpy.array([entropy_bits(symbols[i, :, :, idx_exception])
                             for i in range(nb_images)], dtype=numpy.int64)
    return bits
