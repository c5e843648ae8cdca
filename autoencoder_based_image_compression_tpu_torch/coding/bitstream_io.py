"""The ``.aeic`` bitstream container, byte for byte the reference's.

Layout (little-endian):

    magic 'AEIC'  u32 version
    u16 height_map, u16 width_map, u16 nb_maps, u8 tu_len, u8 flags
    i16 idx_map_exception
    f32 bin_widths[nb_maps]
    f32 map_mean[nb_maps]
    per map (except the exception): u32 bac_bits, u32 bypass_bits,
        payload bytes (bac then bypass, byte-aligned)
    exception map (if any): raw i16 symbols

The truncated-unary probability tables are not stored: they are a
model shared by encoder and decoder, derived from a held-out set.
"""

import ctypes
import struct

import numpy

from autoencoder_based_image_compression_tpu_torch.coding import native
from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
    cast_float_to_int16,
)

_MAGIC = b"AEIC"
_VERSION = 1
_HEADER = "<IHHHBBh"


def encode_map_to_bytes(symbols_int16, probabilities):
    """Encodes one flattened map; returns (bac_bytes, bac_bits, bypass_bytes, bypass_bits)."""
    lib = native.load_library()
    symbols = numpy.ascontiguousarray(symbols_int16, dtype=numpy.int16)
    probs = numpy.ascontiguousarray(probabilities, dtype=numpy.float64)
    capacity = max(64, symbols.size * 8)  # worst case ~34 bits/symbol
    bac = numpy.zeros(capacity, numpy.uint8)
    bypass = numpy.zeros(capacity, numpy.uint8)
    bac_bits = ctypes.c_uint32(0)
    bypass_bits = ctypes.c_uint32(0)
    status = lib.aeic_encode_map(
        ctypes.c_uint32(symbols.size),
        native.as_ptr(symbols, ctypes.c_int16),
        ctypes.c_uint8(probs.size),
        native.as_ptr(probs, ctypes.c_double),
        native.as_ptr(bac, ctypes.c_uint8), capacity,
        native.as_ptr(bypass, ctypes.c_uint8), capacity,
        ctypes.byref(bac_bits), ctypes.byref(bypass_bits))
    if status != 0:
        raise RuntimeError(f"aeic_encode_map returned status {status}.")
    nb_bac = (bac_bits.value + 7) // 8
    nb_byp = (bypass_bits.value + 7) // 8
    return (bac[:nb_bac].tobytes(), bac_bits.value,
            bypass[:nb_byp].tobytes(), bypass_bits.value)


def decode_map_from_bytes(nb_symbols, probabilities, bac_bytes, bac_bits,
                          bypass_bytes, bypass_bits):
    """Decodes one flattened map from its two streams."""
    lib = native.load_library()
    probs = numpy.ascontiguousarray(probabilities, dtype=numpy.float64)
    bac = numpy.frombuffer(bac_bytes, numpy.uint8).copy()
    bypass = numpy.frombuffer(bypass_bytes, numpy.uint8).copy()
    if bac.size == 0:
        bac = numpy.zeros(1, numpy.uint8)
    if bypass.size == 0:
        bypass = numpy.zeros(1, numpy.uint8)
    out = numpy.zeros(nb_symbols, numpy.int16)
    status = lib.aeic_decode_map(
        ctypes.c_uint32(nb_symbols),
        native.as_ptr(out, ctypes.c_int16),
        ctypes.c_uint8(probs.size),
        native.as_ptr(probs, ctypes.c_double),
        native.as_ptr(bac, ctypes.c_uint8),
        ctypes.c_uint32(bac_bits),
        native.as_ptr(bypass, ctypes.c_uint8),
        ctypes.c_uint32(bypass_bits))
    if status != 0:
        raise RuntimeError(f"aeic_decode_map returned status {status}.")
    return out


def write_compressed_latents(path, centered_quantized, bin_widths, map_mean,
                             binary_probabilities, idx_map_exception=-1):
    """Compresses the centered-quantized latents of one image to a file.

    ``centered_quantized`` is the (H_map, W_map, nb_maps) float32 stack
    of bin-width multiples. Returns the file size in bits. Raises when a
    symbol magnitude exceeds the int16 range: a plain cast would wrap,
    and wrapped symbols still round-trip through the coder.
    """
    (height_map, width_map, nb_maps) = centered_quantized.shape
    bin_widths = numpy.asarray(bin_widths, numpy.float32)
    map_mean = numpy.asarray(map_mean, numpy.float32)
    probs = numpy.asarray(binary_probabilities, numpy.float64)
    tu_len = probs.shape[1]
    symbols = cast_float_to_int16(
        centered_quantized / bin_widths.reshape(1, 1, -1))

    chunks = [
        _MAGIC, struct.pack(_HEADER, _VERSION, height_map, width_map, nb_maps,
                            tu_len, 0, idx_map_exception),
        bin_widths.tobytes(), map_mean.tobytes(),
    ]
    for i in range(nb_maps):
        if i == idx_map_exception:
            continue
        (bac, bac_bits, byp, byp_bits) = encode_map_to_bytes(
            symbols[:, :, i].ravel(), probs[i])
        chunks.append(struct.pack("<II", bac_bits, byp_bits))
        chunks.append(bac)
        chunks.append(byp)
    if 0 <= idx_map_exception < nb_maps:
        chunks.append(symbols[:, :, idx_map_exception].ravel().tobytes())
    blob = b"".join(chunks)
    with open(path, "wb") as file:
        file.write(blob)
    return 8 * len(blob)


def read_compressed_latents(path, binary_probabilities):
    """Decompresses a file written by :func:`write_compressed_latents`.

    Returns ``(centered_quantized, bin_widths, map_mean)``.
    """
    with open(path, "rb") as file:
        blob = file.read()
    if blob[:4] != _MAGIC:
        raise ValueError("not an AEIC bitstream file.")
    offset = 4
    (version, height_map, width_map, nb_maps, tu_len, _, idx_exception) = \
        struct.unpack_from(_HEADER, blob, offset)
    if version != _VERSION:
        raise ValueError(f"unsupported bitstream version {version}.")
    offset += struct.calcsize(_HEADER)
    bin_widths = numpy.frombuffer(blob, numpy.float32, nb_maps, offset).copy()
    offset += 4 * nb_maps
    map_mean = numpy.frombuffer(blob, numpy.float32, nb_maps, offset).copy()
    offset += 4 * nb_maps
    probs = numpy.asarray(binary_probabilities, numpy.float64)
    if probs.shape != (nb_maps, tu_len):
        raise ValueError("probability table does not match the bitstream header.")
    nb_symbols = height_map * width_map
    symbols = numpy.zeros((height_map, width_map, nb_maps), numpy.int16)
    for i in range(nb_maps):
        if i == idx_exception:
            continue
        (bac_bits, byp_bits) = struct.unpack_from("<II", blob, offset)
        offset += 8
        nb_bac = (bac_bits + 7) // 8
        nb_byp = (byp_bits + 7) // 8
        bac = blob[offset:offset + nb_bac]
        offset += nb_bac
        byp = blob[offset:offset + nb_byp]
        offset += nb_byp
        symbols[:, :, i] = decode_map_from_bytes(
            nb_symbols, probs[i], bac, bac_bits, byp, byp_bits
        ).reshape(height_map, width_map)
    if 0 <= idx_exception < nb_maps:
        symbols[:, :, idx_exception] = numpy.frombuffer(
            blob, numpy.int16, nb_symbols, offset).reshape(height_map, width_map)
        offset += 2 * nb_symbols
    centered_quantized = symbols.astype(numpy.float32) * bin_widths.reshape(1, 1, -1)
    return (centered_quantized, bin_widths, map_mean)
