"""Hand-written CUDA GDN kernels and their wrappers.

``csrc/gdn.cu`` replaces the reference's two Pallas TPU kernels
(``autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py``):
``_gdn_kernel`` (``gdn_pallas_2d``) and ``_gdn_quantize_kernel``
(``gdn_quantize_pallas_2d``). The source says what bounds them on the
card and how the design answers it.

The library is compiled with ``nvcc`` at first use into ``csrc/build/``
and bound through its plain C interface with ``ctypes``. Each wrapper
takes a ``(rows, 128)`` matrix, and the fp32 GDN of one model
(:func:`gdn_2d`, :func:`gdn_nhwc`, its gradient :func:`gdn_backward`)
also a ``(rows, 192)`` one: for a CPU tensor it runs the plain PyTorch
version below; for a CUDA tensor it launches the kernel on the current
stream or raises. Any other width raises, and so do the bf16, quantising
and stacked calls at 192 channels. Nothing falls back.

``gamma`` is indexed ``[k][c]`` everywhere here, in the kernels and in
the plain versions: ``pool_c = sum_k x_k^2 * gamma[k][c] + beta_c``,
map ``k``'s square in map ``c``'s pool. It need not be symmetric: a
caller whose gamma is indexed the other way (the paper's ``gamma_ck``,
as the scale hyperprior learns it) hands over its transpose.

The fp32 kernel also takes a model axis (:func:`gdn_stacked_2d`): the
gamma ladder's M models side by side in one ``(rows, M, 128)`` tensor,
the output of a convolution grouped over the models, with per-model
gamma and beta; one launch serves every model (the counterpart of the
JAX ladder's ``vmap`` of ``gdn_pallas_2d``).

The fp32 kernel is differentiable: :class:`GdnFunction` and
:class:`GdnStackedFunction` run it as the forward and the gradient kernel
of ``csrc/gdn.cu`` as the backward (:func:`gdn_backward`; one model is a
stack of one), whose plain twin :func:`gdn_backward_plain` holds the
formulas once. The reference has no backward kernel: its training
differentiates the plain einsum, so this one replaces none.
:func:`gdn_2d` goes through :class:`GdnFunction` whenever an operand
requires grad. What is never differentiated in the reference raises
here: a bf16 input or the fused quantiser with an operand that requires
grad. No call returns a detached result quietly.

``LAUNCHES`` counts the kernel launches per variant where they are
launched: the forward's, the backward's tile pass (``*_backward``) and
the reduction that follows it when grad_gamma or grad_beta is asked for
(``gdn_backward_reduce``, GDN and IGDN alike), so a run can show that its
path went through the kernels; a launch at 192 channels counts under its
own name (``gdn_f32_192``, ``igdn_f32_192``, their ``*_backward`` and
``gdn_backward_reduce_192``), so that a step's counts say which width
ran. ``LAUNCH_ROWS`` counts them per variant and row count, so that it
can check the kernels at the row counts its path gave them.

The library also holds the phase marks of a graphed training step
(:func:`launch_mark`, placed by ``utils/tracing.py``): one-thread
kernels, one name a mark, that write the card's global timer into the
epoch's stamps. They are not counted in ``LAUNCHES``. And it holds
Adam's kernel, ``csrc/adam.cu``, whose wrapper and counts are
``ops/kernels/adam_kernel.py``'s.
"""

import collections
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
from autoencoder_based_image_compression_tpu_torch.utils.tracing import mark

CHANNELS = 128
# The widths of the fp32 GDN of one model and its gradient; every other
# kernel takes 128 channels alone.
WIDTHS = (128, 192)
_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SOURCE = os.path.join(_CSRC_DIR, "gdn.cu")
# Every source of the library: the GDN kernels and the marks, and Adam's.
SOURCES = (_SOURCE, os.path.join(_CSRC_DIR, "adam.cu"))
BUILD_DIR = os.path.join(_CSRC_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libaeic_gdn.so")
# ptxas register/shared-memory report of the last build.
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Tile heights of the fp32 kernels by width, tallest first (a block's
# shared memory holds gamma, C^2 floats, and the staged tiles beside it),
# and the SMs of an H100.
FORWARD_TILES = {128: (128, 64, 32), 192: (48, 32)}
TILE_ROWS = FORWARD_TILES[128]
H100_SMS = 132
# Tile heights of the gradient kernel by width (its shared memory holds
# gamma and five tiles of C floats a row). Each of its blocks writes a
# partial grad_gamma and grad_beta, C * C + C floats (the tile pass's grid,
# which the library sizes, says how many blocks a model).
BACKWARD_TILES = {128: (64, 32), 192: (16,)}
BACKWARD_TILE_ROWS = BACKWARD_TILES[128]

LAUNCHES = {"gdn_f32": 0, "igdn_f32": 0, "gdn_bf16": 0, "igdn_bf16": 0,
            "gdn_quantize_f32": 0, "igdn_quantize_f32": 0,
            "gdn_f32_stacked": 0, "igdn_f32_stacked": 0,
            "gdn_f32_backward": 0, "igdn_f32_backward": 0,
            "gdn_f32_stacked_backward": 0, "igdn_f32_stacked_backward": 0,
            "gdn_backward_reduce": 0,
            "gdn_f32_192": 0, "igdn_f32_192": 0,
            "gdn_f32_192_backward": 0, "igdn_f32_192_backward": 0,
            "gdn_backward_reduce_192": 0}
# (variant, rows) -> launches; a stacked variant's rows are (rows a model,
# models), and so are the reduction's, which always takes the model axis.
LAUNCH_ROWS = collections.Counter()
_lib = None
_sm_counts = {}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_ROWS.clear()


def _count(variant, rows):
    LAUNCHES[variant] += 1
    LAUNCH_ROWS[(variant, rows)] += 1


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit.")
    return path


def build_library():
    """Compiles :data:`SOURCES` into ``csrc/build/libaeic_gdn.so``.

    Builds into a temporary name and renames it into place, so that
    concurrent processes never load a half-written library.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    (handle, tmp_path) = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(handle)
    try:
        result = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp_path, *SOURCES],
                                capture_output=True, text=True, check=False)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed on {', '.join(SOURCES)}:\n{result.stderr}")
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
            or os.path.getmtime(LIB_PATH) < max(map(os.path.getmtime, SOURCES))):
        build_library()
    lib = ctypes.CDLL(LIB_PATH)
    pointers = [ctypes.c_void_p] * 4
    rows_inverse = [ctypes.c_int64, ctypes.c_int]
    (tile, stream) = ([ctypes.c_int], [ctypes.c_void_p])
    rows_two = rows_inverse + [ctypes.c_int]  # rows, channels (or models), inverse
    lib.aeic_gdn_f32.argtypes = pointers + rows_two + tile + stream
    lib.aeic_gdn_f32_stacked.argtypes = pointers + rows_two + tile + stream
    lib.aeic_gdn_bf16.argtypes = pointers + rows_inverse + stream
    lib.aeic_gdn_quantize_f32.argtypes = (
        [ctypes.c_void_p] + pointers + rows_inverse + tile + stream)
    lib.aeic_gdn_backward_f32.argtypes = (
        pointers + pointers
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + tile + stream)
    lib.aeic_gdn_backward_blocks.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 3 + tile
    for name in ("aeic_gdn_f32", "aeic_gdn_f32_stacked", "aeic_gdn_bf16",
                 "aeic_gdn_quantize_f32", "aeic_gdn_backward_f32", "aeic_gdn_backward_blocks"):
        getattr(lib, name).restype = ctypes.c_int
    lib.aeic_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aeic_cuda_error_string.restype = ctypes.c_char_p
    lib.aeic_mark_count.restype = ctypes.c_int
    lib.aeic_mark_name.argtypes = [ctypes.c_int]
    lib.aeic_mark_name.restype = ctypes.c_char_p
    lib.aeic_mark.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aeic_mark.restype = ctypes.c_int
    lib.marks = {lib.aeic_mark_name(i).decode(): i for i in range(lib.aeic_mark_count())}
    _lib = lib
    return lib


# --- plain versions --------------------------------------------------------

def gdn_2d_plain(x, gamma, beta, inverse=False):
    """What :func:`gdn_2d` computes, in plain PyTorch."""
    if x.dtype == torch.bfloat16:
        return gdn_lowp(x, gamma, beta, inverse=inverse)
    return (inverse_gdn if inverse else gdn)(x, gamma, beta)


def gdn_stacked_2d_plain(x, gamma, beta, inverse=False):
    """What :func:`gdn_stacked_2d` computes, in plain PyTorch: model
    ``m``'s pool ``x[:, m]^2 @ gamma[m] + beta[m]`` as one batched
    matmul, then GDN or IGDN as :func:`gdn_2d_plain` in fp32."""
    pool = torch.matmul(torch.square(x).transpose(0, 1), gamma).transpose(0, 1) + beta
    return x * (torch.sqrt(pool) if inverse else torch.rsqrt(pool))


def gdn_backward_plain(x, gamma, beta, grad_out, inverse, needs=(True, True, True)):
    """What :func:`gdn_backward` computes, in plain PyTorch: the gradient
    of :func:`gdn_stacked_2d_plain` (one model is a stack of one). With
    ``pool = x^2 @ gamma + beta`` (``gamma[k][c]``, symmetric or not), ``g``
    the incoming gradient ``grad_out`` and ``t = dL/dpool`` (GDN:
    ``-0.5 * g * x * pool^-1.5``; IGDN: ``0.5 * g * x * pool^-0.5``),

        grad_x     = g * scale + 2 * x * (t @ gamma.T)
        grad_gamma = (x^2).T @ t
        grad_beta  = t.sum(0)

    where ``scale`` is ``pool^-0.5`` (GDN) or ``pool^0.5`` (IGDN), each
    model's with its own parameters. Returns ``(grad_x, grad_gamma,
    grad_beta)``, ``None`` where ``needs`` is False."""
    squares = torch.square(x).transpose(0, 1)  # (M, rows, C)
    pool = torch.matmul(squares, gamma).transpose(0, 1) + beta
    if inverse:
        scale = torch.sqrt(pool)
        grad_pool = 0.5 * grad_out * x / scale
    else:
        scale = torch.rsqrt(pool)
        grad_pool = -0.5 * grad_out * x * scale / pool
    by_model = grad_pool.transpose(0, 1)  # (M, rows, C)
    (grad_x, grad_gamma, grad_beta) = (None, None, None)
    if needs[0]:
        grad_x = grad_out * scale + 2.0 * x * torch.matmul(
            by_model, gamma.transpose(-1, -2)).transpose(0, 1)
    if needs[1]:
        grad_gamma = torch.matmul(squares.transpose(-1, -2), by_model)
    if needs[2]:
        grad_beta = grad_pool.sum(0)
    return (grad_x, grad_gamma, grad_beta)


def gdn_quantize_2d_plain(x, gamma, beta, bin_widths, inverse=False):
    """What :func:`gdn_quantize_2d` computes: fp32 GDN/IGDN, then
    ``bw * round(y / bw)`` per channel (uncentred, dequantised)."""
    return quantize_per_map(gdn_2d_plain(x, gamma, beta, inverse), bin_widths)


# --- wrappers ---------------------------------------------------------------

def _widths_text(widths):
    return " or ".join(str(width) for width in widths)


def _check_operands(x, gamma, beta, dtypes, widths=(CHANNELS,)):
    """Raises unless ``x`` is ``(rows, C)`` of a dtype of ``dtypes``, C one
    of ``widths``, with gamma ``(C, C)`` and beta ``(C,)``; returns C."""
    if x.dim() != 2 or x.shape[1] not in widths:
        raise ValueError(f"expected x of shape (rows, {_widths_text(widths)}), got "
                         f"{tuple(x.shape)}.")
    if x.dtype not in dtypes:
        raise TypeError(f"x.dtype {x.dtype} not in {dtypes}.")
    channels = x.shape[1]
    if tuple(gamma.shape) != (channels, channels) or tuple(beta.shape) != (channels,):
        raise ValueError(f"expected gamma ({channels}, {channels}) and beta ({channels},) for "
                         f"x of {channels} channels, got {tuple(gamma.shape)} and "
                         f"{tuple(beta.shape)}.")
    return channels


def _variant(name, channels):
    """The ``LAUNCHES`` name of a launch of ``name`` (a 128-channel name) at
    ``channels``: at 192 ``[i]gdn_f32_192``, ``[i]gdn_f32_192_backward``,
    ``gdn_backward_reduce_192``."""
    if channels == CHANNELS:
        return name
    if name == "gdn_backward_reduce":
        return f"{name}_{channels}"
    return name.replace("_f32", f"_f32_{channels}", 1)


def tile_rows(rows, sms=H100_SMS, heights=TILE_ROWS):
    """Tile height of the fp32 kernels for a row count, of ``heights``
    (tallest first; the gradient kernel's are :data:`BACKWARD_TILE_ROWS`).

    The blocks are persistent, about one to an SM, so the busiest SM
    works through ``ceil(tiles / sms)`` tiles. Take the height that
    gives it the fewest rows, and of equals the tallest, which reuses
    the most of what it loads.
    """
    def busiest(height):
        tiles = -(-rows // height)
        return -(-tiles // sms) * height

    return min(heights, key=busiest)


def _sm_count(device):
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _cuda_operands(x, *params):
    """The parameters as fp32 contiguous tensors on ``x``'s device (the
    tensors themselves when they already are, as on every path of this
    package), after the checks the kernel needs."""
    if x.device.type != "cuda":
        raise ValueError(f"the GDN kernels run on CUDA or CPU tensors, got {x.device}.")
    if not x.is_contiguous():
        raise ValueError(f"x must be C-contiguous, got strides {x.stride()}.")
    out = []
    for param in params:
        if param.device != x.device:
            raise ValueError(f"parameter on {param.device}, x on {x.device}.")
        if param.dtype != torch.float32 or not param.is_contiguous():
            param = param.to(torch.float32).contiguous()
        out.append(param)
    if any(t.data_ptr() % 16 for t in (x, *out)):
        raise ValueError("the GDN kernels need 16-byte aligned x and parameters.")
    return out


def _raise_on_status(lib, status, name):
    if status != 0:
        message = lib.aeic_cuda_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({message}).")


def _gdn_2d_forward(x, gamma, beta, inverse):
    """Plain version for a CPU tensor, one kernel launch for a CUDA one."""
    if x.device.type == "cpu":
        return gdn_2d_plain(x, gamma, beta, inverse)
    (gamma, beta) = _cuda_operands(x, gamma, beta)
    out = torch.empty_like(x)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    (rows, channels) = x.shape
    pointers = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    if x.dtype == torch.float32:
        variant = "f32"
        tile = tile_rows(rows, _sm_count(x.device), FORWARD_TILES[channels])
        status = lib.aeic_gdn_f32(*pointers, rows, channels, int(inverse), tile, stream)
    else:
        variant = "bf16"
        status = lib.aeic_gdn_bf16(*pointers, rows, int(inverse), stream)
    _raise_on_status(lib, status, "gdn_2d")
    _count(_variant(("igdn_" if inverse else "gdn_") + variant, channels), rows)
    return out


def gdn_backward(x, gamma, beta, grad_out, inverse, needs=(True, True, True), stacked=True):
    """The gradient of :func:`gdn_stacked_2d` (one model: a stack of one):
    ``x`` and ``grad_out`` ``(rows, M, C)``, gamma ``(M, C, C)``, beta
    ``(M, C)``; returns ``(grad_x, grad_gamma, grad_beta)``, ``None`` where
    ``needs`` is False; on the card C is 128, or 192 for a single model
    (``stacked`` False, M = 1), and another width raises. ``grad_out``
    must have ``x``'s shape and be C-contiguous, on every device. A CPU
    tensor (of any width) takes
    :func:`gdn_backward_plain`; a CUDA one the gradient kernel, a tile pass
    and, for grad_gamma or grad_beta, a reduction of its blocks' partials in
    a fixed order, on the current stream, or raises. The tile pass counts
    as ``[i]gdn_f32_stacked_backward`` at ``(rows, M)``, or with ``stacked``
    False (the backward of :class:`GdnFunction`, M = 1) as
    ``[i]gdn_f32_backward`` at ``rows``; the reduction as
    ``gdn_backward_reduce`` at ``(rows, M)``; at 192 channels under their
    ``_192`` names."""
    if tuple(grad_out.shape) != tuple(x.shape):
        raise ValueError(f"grad_out of shape {tuple(grad_out.shape)}, x of "
                         f"{tuple(x.shape)}.")
    if not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be C-contiguous (rows, models, channels), got "
                         f"strides {grad_out.stride()}.")
    if not stacked and x.shape[1] != 1:
        raise ValueError(f"a single model's backward got {x.shape[1]} models.")
    if x.device.type == "cpu":
        return gdn_backward_plain(x, gamma, beta, grad_out, inverse, needs)
    _check_stacked_operands(x, gamma, beta, (CHANNELS,) if stacked else WIDTHS)
    if grad_out.dtype != torch.float32 or grad_out.device != x.device:
        raise TypeError(f"grad_out must be fp32 on {x.device}, got {grad_out.dtype} on "
                        f"{grad_out.device}.")
    (gamma, beta, grad_out) = _cuda_operands(x, gamma, beta, grad_out)
    (rows, models, channels) = x.shape
    tile = tile_rows(rows, max(1, _sm_count(x.device) // models), BACKWARD_TILES[channels])
    lib = load_library()
    blocks = lib.aeic_gdn_backward_blocks(rows, models, channels, int(inverse), tile)
    if blocks < 0:
        _raise_on_status(lib, -blocks, "gdn_backward")
    grad_x = torch.empty_like(x) if needs[0] else None
    grad_gamma = torch.empty_like(gamma) if needs[1] else None
    grad_beta = torch.empty_like(beta) if needs[2] else None
    reduce = needs[1] or needs[2]
    partials = (torch.empty((models, blocks, channels * channels + channels),
                            dtype=torch.float32, device=x.device) if reduce else None)
    pointer = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    status = lib.aeic_gdn_backward_f32(
        x.data_ptr(), grad_out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pointer(grad_x),
        pointer(partials), pointer(grad_gamma), pointer(grad_beta), rows, models, blocks,
        channels, int(inverse), tile, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_status(lib, status, "gdn_backward")
    forward = "igdn_f32" if inverse else "gdn_f32"
    if stacked:
        _count(forward + "_stacked_backward", (rows, models))
    else:
        _count(_variant(forward + "_backward", channels), rows)
    if reduce:
        _count(_variant("gdn_backward_reduce", channels), (rows, models))
    return (grad_x, grad_gamma, grad_beta)


def _backward(ctx, grad_out, stacked):
    """The backward of both functions: :func:`gdn_backward` between the
    marks ``gdn_backward_begin`` and ``gdn_backward_end``
    (``utils/tracing.py``); a single model goes in as a stack of one."""
    mark("gdn_backward_begin")
    (x, gamma, beta) = ctx.saved_tensors
    grad_out = grad_out.contiguous()
    if not stacked:
        (x, gamma, beta, grad_out) = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                                      grad_out.unsqueeze(1))
    grads = gdn_backward(x, gamma, beta, grad_out, ctx.inverse, ctx.needs_input_grad[:3],
                         stacked)
    if not stacked:
        (grad_x, grad_gamma, grad_beta) = grads
        grads = (None if grad_x is None else grad_x[:, 0],
                 None if grad_gamma is None else grad_gamma[0],
                 None if grad_beta is None else grad_beta[0])
    mark("gdn_backward_end")
    return (*grads, None)


class GdnFunction(torch.autograd.Function):
    """Differentiable GDN/IGDN on a ``(rows, C)`` matrix.

    Forward: the kernel on the card, the plain version on the CPU.
    Backward: :func:`gdn_backward` on the model as a stack of one, the
    gradient kernel on the card and :func:`gdn_backward_plain` (whose
    docstring holds the formulas) on the CPU. The pool is computed again
    in the backward, so the forward saves only its inputs. The backward
    opens with the mark ``gdn_backward_begin`` and closes with
    ``gdn_backward_end`` (``utils/tracing.py``).
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        return _gdn_2d_forward(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, grad_out):
        return _backward(ctx, grad_out, stacked=False)


def _check_stacked_operands(x, gamma, beta, widths=(CHANNELS,)):
    if x.dim() != 3 or x.shape[2] not in widths:
        raise ValueError(f"expected x of shape (rows, models, {_widths_text(widths)}), "
                         f"got {tuple(x.shape)}.")
    if x.dtype != torch.float32:
        raise TypeError(f"the stacked GDN runs in fp32, got {x.dtype}.")
    (models, channels) = x.shape[1:]
    if (tuple(gamma.shape) != (models, channels, channels)
            or tuple(beta.shape) != (models, channels)):
        raise ValueError(f"expected gamma ({models}, {channels}, {channels}) and beta "
                         f"({models}, {channels}), got {tuple(gamma.shape)} and "
                         f"{tuple(beta.shape)}.")


def _gdn_stacked_forward(x, gamma, beta, inverse):
    """Plain version for a CPU tensor, one kernel launch for a CUDA one."""
    if x.device.type == "cpu":
        return gdn_stacked_2d_plain(x, gamma, beta, inverse)
    (gamma, beta) = _cuda_operands(x, gamma, beta)
    (rows, models) = (x.shape[0], x.shape[1])
    out = torch.empty_like(x)
    lib = load_library()
    # The card's SMs are shared among the models: the tile height that
    # gives the busiest SM the fewest rows of one model.
    tile = tile_rows(rows, max(1, _sm_count(x.device) // models))
    status = lib.aeic_gdn_f32_stacked(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                      out.data_ptr(), rows, models, int(inverse), tile,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_status(lib, status, "gdn_stacked_2d")
    _count("igdn_f32_stacked" if inverse else "gdn_f32_stacked", (rows, models))
    return out


class GdnStackedFunction(torch.autograd.Function):
    """Differentiable GDN/IGDN with a model axis, ``(rows, M, C)``.

    Forward: the stacked kernel on the card, the plain version on the
    CPU. Backward: :func:`gdn_backward`, as :class:`GdnFunction`'s,
    between the same two marks.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        return _gdn_stacked_forward(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, grad_out):
        return _backward(ctx, grad_out, stacked=True)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gdn_2d(x, gamma, beta, inverse=False):
    """GDN (or IGDN) on a ``(rows, 128)`` fp32 or bf16 matrix, or a
    ``(rows, 192)`` fp32 one.

    Counterpart of ``gdn_pallas_2d``: gamma, ``(C, C)`` indexed
    ``[k][c]``, is rounded to x's dtype, beta stays fp32, the output has
    x's dtype. When an operand requires grad the fp32 call goes through
    :class:`GdnFunction`; a bf16 one raises.
    """
    channels = _check_operands(x, gamma, beta, (torch.float32, torch.bfloat16), WIDTHS)
    if channels != CHANNELS and x.dtype != torch.float32:
        raise TypeError(f"gdn_2d runs bf16 at {CHANNELS} channels only, got {x.dtype} at "
                        f"{channels}.")
    if _needs_grad(x, gamma, beta):
        if x.dtype != torch.float32:
            raise TypeError("gdn_2d is differentiable in fp32 only: a bf16 input "
                            "with an operand that requires grad is refused.")
        return GdnFunction.apply(x, gamma, beta, inverse)
    return _gdn_2d_forward(x, gamma, beta, inverse)


def gdn_stacked_2d(x, gamma, beta, inverse=False):
    """GDN (or IGDN) of M models at once: ``x`` is ``(rows, M, 128)``
    fp32 and C-contiguous, gamma ``(M, 128, 128)``, beta ``(M, 128)``
    (128 channels only);
    ``out[:, m]`` is :func:`gdn_2d` of ``x[:, m]`` with model ``m``'s
    parameters, bit for bit on the card. Differentiable through
    :class:`GdnStackedFunction`."""
    _check_stacked_operands(x, gamma, beta)
    if _needs_grad(x, gamma, beta):
        return GdnStackedFunction.apply(x, gamma, beta, inverse)
    return _gdn_stacked_forward(x, gamma, beta, inverse)


def gdn_quantize_2d(x, gamma, beta, bin_widths, inverse=False):
    """Fused fp32 GDN/IGDN + per-channel quantiser on ``(rows, 128)``.

    Counterpart of ``gdn_quantize_pallas_2d``: returns
    ``bw * round(gdn(x) / bw)``, rounding half to even. 128 channels only.
    Raises when an operand requires grad.
    """
    _check_operands(x, gamma, beta, (torch.float32,))
    if tuple(bin_widths.shape) != (CHANNELS,):
        raise ValueError(f"expected bin_widths of shape ({CHANNELS},), got "
                         f"{tuple(bin_widths.shape)}.")
    if _needs_grad(x, gamma, beta, bin_widths):
        raise RuntimeError("gdn_quantize_2d is not differentiable (the rounding has no "
                           "gradient): an operand requires grad. Train through gdn_2d "
                           "and additive noise.")
    if x.device.type == "cpu":
        return gdn_quantize_2d_plain(x, gamma, beta, bin_widths, inverse)
    (gamma, beta, bin_widths) = _cuda_operands(x, gamma, beta, bin_widths)
    out = torch.empty_like(x)
    lib = load_library()
    status = lib.aeic_gdn_quantize_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bin_widths.data_ptr(),
        out.data_ptr(), x.shape[0], int(inverse),
        tile_rows(x.shape[0], _sm_count(x.device)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_status(lib, status, "gdn_quantize_2d")
    _count("igdn_quantize_f32" if inverse else "gdn_quantize_f32", x.shape[0])
    return out


def gdn_nhwc(x_nhwc, gamma, beta, inverse=False):
    """NHWC wrapper of :func:`gdn_2d` (counterpart of ``gdn_pallas``), at
    128 or 192 channels.

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


def gdn_stacked_nhwc(x_nhwc, gamma, beta, inverse=False):
    """NHWC wrapper of :func:`gdn_stacked_2d`: ``x_nhwc`` is ``(B, H, W,
    M * 128)``, model ``m``'s maps at channels ``m * 128 ..``, which is
    what a convolution grouped over the models gives. The reshape is a
    view of a channels-last result."""
    shape = x_nhwc.shape
    x = x_nhwc.reshape(-1, gamma.shape[0], CHANNELS)
    return gdn_stacked_2d(x, gamma, beta, inverse).reshape(shape)


def launch_mark(name, stamps, counter, slot):
    """Launches the mark kernel ``aeic_mark_<name>`` on the current stream:
    it writes the card's global timer (ns) into ``stamps[counter, slot]``,
    ``stamps`` a ``(rows, slots)`` int64 CUDA tensor and ``counter`` the
    epoch's one-element int64 step counter on the same device."""
    lib = load_library()
    which = lib.marks.get("aeic_mark_" + name)
    if which is None:
        raise ValueError(f"no mark kernel aeic_mark_{name} in {LIB_PATH}.")
    if stamps.dtype != torch.int64 or counter.dtype != torch.int64 or stamps.dim() != 2:
        raise ValueError("the stamps are a (rows, slots) and the counter a (1,) int64 tensor.")
    status = lib.aeic_mark(which, stamps.data_ptr(), counter.data_ptr(), stamps.shape[0],
                           stamps.shape[1], slot,
                           torch.cuda.current_stream(stamps.device).cuda_stream)
    _raise_on_status(lib, status, "aeic_mark_" + name)
