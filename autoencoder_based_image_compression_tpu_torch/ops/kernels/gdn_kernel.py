"""Hand-written CUDA GDN kernels and their wrappers.

``csrc/gdn.cu`` replaces the reference's two Pallas TPU kernels
(``autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py``):
``_gdn_kernel`` (``gdn_pallas_2d``) and ``_gdn_quantize_kernel``
(``gdn_quantize_pallas_2d``). The source says what bounds them on the
card and how the design answers it.

The library is compiled with ``nvcc`` at first use into ``csrc/build/``
and bound through its plain C interface with ``ctypes``. Each wrapper
takes a ``(rows, 128)`` matrix: for a CPU tensor it runs the plain
PyTorch version below; for a CUDA tensor it launches the kernel on the
current stream or raises. Nothing falls back.

``LAUNCHES`` counts the kernel launches per variant, so a run can show
that its path went through the kernels.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

from autoencoder_based_image_compression_tpu_torch.ops.gdn import (
    gdn,
    gdn_lowp,
    inverse_gdn,
)
from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
    quantize_per_map,
)

CHANNELS = 128
_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SOURCE = os.path.join(_CSRC_DIR, "gdn.cu")
BUILD_DIR = os.path.join(_CSRC_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libaeic_gdn.so")
# ptxas register/shared-memory report of the last build.
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"gdn_f32": 0, "igdn_f32": 0, "gdn_bf16": 0, "igdn_bf16": 0,
            "gdn_quantize_f32": 0, "igdn_quantize_f32": 0}
_lib = None


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit.")
    return path


def build_library():
    """Compiles ``csrc/gdn.cu`` into ``csrc/build/libaeic_gdn.so``.

    Builds into a temporary name and renames it into place, so that
    concurrent processes never load a half-written library.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    (handle, tmp_path) = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(handle)
    try:
        result = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp_path, _SOURCE],
                                capture_output=True, text=True, check=False)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{result.stderr}")
        with open(BUILD_LOG, "w") as log:
            log.write(result.stdout + result.stderr)
        os.replace(tmp_path, LIB_PATH)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def load_library():
    """Loads the kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.isfile(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SOURCE)):
        build_library()
    lib = ctypes.CDLL(LIB_PATH)
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    for name in ("aeic_gdn_f32", "aeic_gdn_bf16"):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    lib.aeic_gdn_quantize_f32.argtypes = [ctypes.c_void_p] + args
    lib.aeic_gdn_quantize_f32.restype = ctypes.c_int
    lib.aeic_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aeic_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


# --- plain versions --------------------------------------------------------

def gdn_2d_plain(x, gamma, beta, inverse=False):
    """What :func:`gdn_2d` computes, in plain PyTorch."""
    if x.dtype == torch.bfloat16:
        return gdn_lowp(x, gamma, beta, inverse=inverse)
    return (inverse_gdn if inverse else gdn)(x, gamma, beta)


def gdn_quantize_2d_plain(x, gamma, beta, bin_widths, inverse=False):
    """What :func:`gdn_quantize_2d` computes: fp32 GDN/IGDN, then
    ``bw * round(y / bw)`` per channel (uncentred, dequantised)."""
    return quantize_per_map(gdn_2d_plain(x, gamma, beta, inverse), bin_widths)


# --- wrappers ---------------------------------------------------------------

def _check_operands(x, gamma, beta, dtypes):
    if x.dim() != 2 or x.shape[1] != CHANNELS:
        raise ValueError(f"expected x of shape (rows, {CHANNELS}), got {tuple(x.shape)}.")
    if x.dtype not in dtypes:
        raise TypeError(f"x.dtype {x.dtype} not in {dtypes}.")
    if tuple(gamma.shape) != (CHANNELS, CHANNELS) or tuple(beta.shape) != (CHANNELS,):
        raise ValueError("expected gamma (128, 128) and beta (128,).")


def _cuda_operands(x, *params):
    """fp32 contiguous copies of the parameters on ``x``'s device (no
    copy when they already are), after the checks the kernel needs."""
    if x.device.type != "cuda":
        raise ValueError(f"the GDN kernels run on CUDA or CPU tensors, got {x.device}.")
    if not x.is_contiguous():
        raise ValueError("x must be C-contiguous (rows, 128).")
    out = []
    for param in params:
        if param.device != x.device:
            raise ValueError(f"parameter on {param.device}, x on {x.device}.")
        out.append(param.to(torch.float32).contiguous())
    return out


def _raise_on_status(lib, status, name):
    if status != 0:
        message = lib.aeic_cuda_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({message}).")


def gdn_2d(x, gamma, beta, inverse=False):
    """GDN (or IGDN) on a ``(rows, 128)`` fp32 or bf16 matrix.

    Counterpart of ``gdn_pallas_2d``: gamma is rounded to x's dtype,
    beta stays fp32, the output has x's dtype.
    """
    _check_operands(x, gamma, beta, (torch.float32, torch.bfloat16))
    if x.device.type == "cpu":
        return gdn_2d_plain(x, gamma, beta, inverse)
    (gamma, beta) = _cuda_operands(x, gamma, beta)
    out = torch.empty_like(x)
    lib = load_library()
    if x.dtype == torch.float32:
        (fn, variant) = (lib.aeic_gdn_f32, "f32")
    else:
        (fn, variant) = (lib.aeic_gdn_bf16, "bf16")
    status = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                x.shape[0], int(inverse), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_status(lib, status, "gdn_2d")
    LAUNCHES[("igdn_" if inverse else "gdn_") + variant] += 1
    return out


def gdn_quantize_2d(x, gamma, beta, bin_widths, inverse=False):
    """Fused fp32 GDN/IGDN + per-channel quantiser on ``(rows, 128)``.

    Counterpart of ``gdn_quantize_pallas_2d``: returns
    ``bw * round(gdn(x) / bw)``, rounding half to even.
    """
    _check_operands(x, gamma, beta, (torch.float32,))
    if tuple(bin_widths.shape) != (CHANNELS,):
        raise ValueError("expected bin_widths of shape (128,).")
    if x.device.type == "cpu":
        return gdn_quantize_2d_plain(x, gamma, beta, bin_widths, inverse)
    (gamma, beta, bin_widths) = _cuda_operands(x, gamma, beta, bin_widths)
    out = torch.empty_like(x)
    lib = load_library()
    status = lib.aeic_gdn_quantize_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bin_widths.data_ptr(),
        out.data_ptr(), x.shape[0], int(inverse),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_status(lib, status, "gdn_quantize_2d")
    LAUNCHES["igdn_quantize_f32" if inverse else "gdn_quantize_f32"] += 1
    return out


def gdn_nhwc(x_nhwc, gamma, beta, inverse=False):
    """NHWC wrapper of :func:`gdn_2d` (counterpart of ``gdn_pallas``).

    Flattening is a view for C-contiguous NHWC input, which is what the
    channels-last convolutions of the transforms produce.
    """
    shape = x_nhwc.shape
    return gdn_2d(x_nhwc.reshape(-1, shape[-1]), gamma, beta, inverse).reshape(shape)


def gdn_quantize_nhwc(x_nhwc, gamma, beta, bin_widths, inverse=False):
    """NHWC wrapper of :func:`gdn_quantize_2d`."""
    shape = x_nhwc.shape
    return gdn_quantize_2d(x_nhwc.reshape(-1, shape[-1]), gamma, beta, bin_widths,
                           inverse).reshape(shape)
