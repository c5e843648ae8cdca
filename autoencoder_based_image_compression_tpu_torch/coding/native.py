"""ctypes bindings to the C++ lossless coding core.

The port keeps its own copy of the coder sources (``coding/cpp/``) and
builds its own ``libaeic_coder.so`` from them at first use, with the
same symbols and argument types as the reference package's binding.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy

CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
BUILD_DIR = os.path.join(CPP_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libaeic_coder.so")
_lib = None


def build_library():
    """Builds ``libaeic_coder.so`` with the sources' Makefile.

    ``make`` writes into a private temporary directory and the library
    is renamed into place, so concurrent builds (pytest workers) never
    link into, or load, the same half-written file.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp_lib = os.path.join(tmp_dir, "libaeic_coder.so")
        subprocess.check_call(["make", "-C", CPP_DIR, f"BUILD={tmp_dir}", tmp_lib],
                              stdout=subprocess.DEVNULL)
        os.replace(tmp_lib, LIB_PATH)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def load_library():
    """Loads (building first if needed) the coder shared library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.isfile(LIB_PATH):
        build_library()
    lib = ctypes.CDLL(LIB_PATH)
    lib.aeic_compress_lossless.restype = ctypes.c_int
    lib.aeic_compress_lossless.argtypes = [
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.aeic_compress_lossless_batch.restype = ctypes.c_int
    lib.aeic_compress_lossless_batch.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
    ]
    lib.aeic_compress_lossless_batch_ex.restype = ctypes.c_int
    lib.aeic_compress_lossless_batch_ex.argtypes = (
        lib.aeic_compress_lossless_batch.argtypes + [ctypes.c_uint32])
    lib.aeic_encode_map.restype = ctypes.c_int
    lib.aeic_encode_map.argtypes = [
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int16), ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    lib.aeic_decode_map.restype = ctypes.c_int
    lib.aeic_decode_map.argtypes = [
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int16), ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32]
    _lib = lib
    return lib


def as_ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def compress_lossless_flattened_map(ref_map_int16, probabilities):
    """Round-trips one flattened int16 map through the C++ coder.

    Same contract as the reference's Cython entry
    (``interface_cython.pyx:13-61``): returns ``(reconstruction,
    nb_bits)``; the truncated-unary length is ``probabilities.size`` and
    must fit a uint8. Raises ``TypeError`` / ``ValueError`` on contract
    violations and ``RuntimeError`` when the C++ core reports an error.
    """
    if ref_map_int16.dtype != numpy.int16:
        raise TypeError("`ref_map_int16.dtype` is not equal to `numpy.int16`.")
    if ref_map_int16.ndim != 1:
        raise ValueError("`ref_map_int16.ndim` is not equal to 1.")
    probabilities = numpy.ascontiguousarray(probabilities, dtype=numpy.float64)
    if probabilities.ndim != 1:
        raise ValueError("`probabilities.ndim` is not equal to 1.")
    if probabilities.size > 255:
        raise ValueError("The truncated-unary length does not fit a uint8.")
    lib = load_library()
    ref = numpy.ascontiguousarray(ref_map_int16)
    rec = numpy.zeros_like(ref)
    nb_bits = ctypes.c_uint32(0)
    status = lib.aeic_compress_lossless(
        ctypes.c_uint32(ref.size),
        as_ptr(ref, ctypes.c_int16),
        as_ptr(rec, ctypes.c_int16),
        ctypes.c_uint8(probabilities.size),
        as_ptr(probabilities, ctypes.c_double),
        ctypes.byref(nb_bits),
    )
    if status != 0:
        raise RuntimeError(f"C++ coder returned error status {status}.")
    return (rec, int(nb_bits.value))


def compress_lossless_batch(ref_maps_int16, probabilities, nb_threads=0,
                            verify=True):
    """Codes a stack of maps on the C++ thread pool.

    ``ref_maps_int16`` is ``(nb_maps, map_size)`` int16 and
    ``probabilities`` ``(nb_maps, tu_len)`` float64 (per-map
    truncated-unary zero-probabilities); both are made C-contiguous
    before their pointers are passed. ``nb_threads`` 0 selects the
    hardware concurrency. ``verify=True`` round-trips every map
    (encode + verify-decode); ``verify=False`` encodes only, giving the
    same bitstreams and bit counts.

    Returns ``(reconstructions, nb_bits_per_map)``; with
    ``verify=False`` the reconstructions are ``None``.
    """
    ref = numpy.ascontiguousarray(ref_maps_int16, dtype=numpy.int16)
    probs = numpy.ascontiguousarray(probabilities, dtype=numpy.float64)
    if ref.ndim != 2 or probs.ndim != 2 or probs.shape[0] != ref.shape[0]:
        raise ValueError("expected (nb_maps, map_size) symbols and (nb_maps, tu_len) probabilities.")
    if probs.shape[1] > 255:
        raise ValueError("The truncated-unary length does not fit a uint8.")
    lib = load_library()
    rec = None if not verify else numpy.zeros_like(ref)
    nb_bits = numpy.zeros(ref.shape[0], dtype=numpy.uint32)
    status = lib.aeic_compress_lossless_batch_ex(
        ctypes.c_uint32(ref.shape[0]),
        ctypes.c_uint32(ref.shape[1]),
        as_ptr(ref, ctypes.c_int16),
        (ctypes.POINTER(ctypes.c_int16)() if rec is None
         else as_ptr(rec, ctypes.c_int16)),
        ctypes.c_uint8(probs.shape[1]),
        as_ptr(probs, ctypes.c_double),
        as_ptr(nb_bits, ctypes.c_uint32),
        ctypes.c_uint32(nb_threads),
        ctypes.c_uint32(0 if verify else 1),
    )
    if status != 0:
        raise RuntimeError(f"C++ coder returned error status {status}.")
    return (rec, nb_bits)
