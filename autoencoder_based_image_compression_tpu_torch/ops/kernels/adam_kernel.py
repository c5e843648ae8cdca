"""Adam's update as one hand-written CUDA kernel, and its plain twin.

``csrc/adam.cu`` (``adam_f32_kernel``, entry ``aeic_adam_f32``) is built
into the GDN kernels' library (``gdn_kernel.load_library``) and bound
here through its plain C interface with ``ctypes``. It replaces no TPU
kernel: the JAX package writes Adam as array arithmetic, which XLA fuses
leaf by leaf under ``jit``; eagerly, the same arithmetic is 14
elementwise kernels a leaf. The source says what bounds the kernel on
the card and how its design answers.

:func:`adam_leaves` updates the leaves of one Adam step, each a tuple
``(p, g, mu, nu)`` of tensors of one shape, at the rate ``lr`` with the
bias corrections ``correction_1`` and ``correction_2``. Each of the three
is a number, a scalar tensor, or for M stacked models an ``(M,)`` tensor
applied to model ``m``'s slice ``[m]`` of every leaf. On CPU tensors it
runs :func:`adam_leaves_plain`, the per-leaf chain; on CUDA tensors it
launches the kernel, up to :data:`MAX_LEAVES` leaves a launch, or raises.
Nothing falls back. The arithmetic is the chain's, operation for
operation, so the two agree bit for bit on the card.

``LAUNCHES["adam_f32"]`` counts the launches where Python makes them (a
CUDA graph's capture counts, its replays do not), and ``LAUNCH_SHAPES``
counts them per ``(leaves, models)`` of the launch.
"""

import collections
import ctypes

import torch

from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1.0e-8

# Leaves a launch (the parameter struct holds them by value), and the
# elements a block: 256 threads of 4 float4 each (csrc/adam.cu).
MAX_LEAVES = 32
CHUNK = 4096

LAUNCHES = {"adam_f32": 0}
# (leaves, models) -> launches.
LAUNCH_SHAPES = collections.Counter()
_lib = None


def reset_launch_counts():
    LAUNCHES["adam_f32"] = 0
    LAUNCH_SHAPES.clear()


# --- plain version ------------------------------------------------------------

def _per_model(value, leaf):
    """``value`` against ``leaf``: an ``(M,)`` tensor as ``(M, 1, ...)``."""
    if not torch.is_tensor(value):
        return value
    return value.reshape(value.shape + (1,) * (leaf.dim() - value.dim()))


def adam_leaves_plain(leaves, lr, correction_1, correction_2):
    """What :func:`adam_leaves` computes, in plain PyTorch, leaf by leaf:
    ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``, ``p - lr *
    (mu / correction_1) / (sqrt(nu / correction_2) + 1e-8)``. Returns
    ``[(p, mu, nu)]``, new tensors, in the leaves' order."""
    updated = []
    for (p, g, mu, nu) in leaves:
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu
        update = (mu / _per_model(correction_1, g)) / (
            torch.sqrt(nu / _per_model(correction_2, g)) + ADAM_EPS)
        updated.append((p - _per_model(lr, g) * update, mu, nu))
    return updated


# --- the launch plan ----------------------------------------------------------

def launch_plan(sizes, models):
    """The launches of one step over leaves of ``models[i]`` slices of
    ``sizes[i]`` elements each: a list with one ``(entries, blocks)`` a
    launch, ``entries`` the ``(leaf, blocks_per_model, first_block)`` of
    at most :data:`MAX_LEAVES` leaves in order and ``blocks`` the grid. A
    leaf takes ``ceil(size / CHUNK)`` blocks a model, model after model;
    a leaf with no element takes none."""
    (launches, entries, blocks) = ([], [], 0)
    for (leaf, (size, nb_models)) in enumerate(zip(sizes, models)):
        if size * nb_models == 0:
            continue
        if len(entries) == MAX_LEAVES:
            launches.append((entries, blocks))
            (entries, blocks) = ([], 0)
        per_model = -(-size // CHUNK)
        entries.append((leaf, per_model, blocks))
        blocks += per_model * nb_models
    if entries:
        launches.append((entries, blocks))
    return launches


# --- the kernel -----------------------------------------------------------------

_POINTERS = ("p", "g", "mu", "nu", "p_out", "mu_out", "nu_out")


class _Leaf(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [("size", ctypes.c_int64), ("blocks_per_model", ctypes.c_int),
                   ("first_block", ctypes.c_int)])


class _PerModel(ctypes.Structure):
    _fields_ = [("values", ctypes.c_void_p), ("step", ctypes.c_int), ("value", ctypes.c_float)]


class _Args(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("leaves", ctypes.c_int), ("lr", _PerModel),
                ("c1", _PerModel), ("c2", _PerModel), ("b1", ctypes.c_float),
                ("one_minus_b1", ctypes.c_float), ("b2", ctypes.c_float),
                ("one_minus_b2", ctypes.c_float), ("eps", ctypes.c_float)]


def load_library():
    """The kernel library, its Adam entry bound and its structs checked
    against this module's mirror of them."""
    global _lib
    if _lib is None:
        lib = gdn_kernel.load_library()
        lib.aeic_adam_f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.aeic_adam_f32.restype = ctypes.c_int
        got = (lib.aeic_adam_max_leaves(), lib.aeic_adam_chunk(), lib.aeic_adam_args_bytes())
        if got != (MAX_LEAVES, CHUNK, ctypes.sizeof(_Args)):
            raise RuntimeError(f"{gdn_kernel.LIB_PATH}: Adam's leaves, chunk and struct bytes "
                               f"{got}, expected {(MAX_LEAVES, CHUNK, ctypes.sizeof(_Args))}.")
        _lib = lib
    return _lib


def _value(name, value, device):
    """``(per-model struct, M)``: ``M`` the length of an ``(M,)`` tensor,
    else ``None``."""
    if not torch.is_tensor(value):
        return (_PerModel(None, 0, float(value)), None)
    if value.dim() > 1 or value.dtype != torch.float32 or value.device != device:
        raise ValueError(f"{name} must be a number or a scalar or (M,) fp32 tensor on {device}, "
                         f"got {tuple(value.shape)} {value.dtype} on {value.device}.")
    if not value.is_contiguous():
        raise ValueError(f"{name} must be contiguous.")
    return (_PerModel(value.data_ptr(), value.dim(), 0.0),
            value.shape[0] if value.dim() else None)


def _check_leaf(index, leaf, device, models):
    if len(leaf) != 4:
        raise ValueError(f"leaf {index}: expected (p, g, mu, nu), got {len(leaf)} tensors.")
    p = leaf[0]
    for (name, t) in zip(_POINTERS, leaf):
        if t.dtype != torch.float32:
            raise TypeError(f"leaf {index}: Adam's kernel runs in fp32, {name} is {t.dtype}.")
        if t.device != device:
            raise ValueError(f"leaf {index}: {name} on {t.device}, the step on {device}.")
        if not t.is_contiguous():
            raise ValueError(f"leaf {index}: {name} must be C-contiguous.")
        if t.shape != p.shape:
            raise ValueError(f"leaf {index}: {name} of shape {tuple(t.shape)}, p of "
                             f"{tuple(p.shape)}.")
    if models is not None and (p.dim() == 0 or p.shape[0] != models):
        raise ValueError(f"leaf {index} of shape {tuple(p.shape)}: per-model values for "
                         f"{models} models need a leading axis of {models}.")


def adam_leaves(leaves, lr, correction_1, correction_2):
    """One Adam step of ``leaves``, a list of ``(p, g, mu, nu)``: returns
    ``[(p, mu, nu)]``, new tensors, in order. CPU tensors take
    :func:`adam_leaves_plain`; CUDA ones the kernel (fp32, C-contiguous,
    one device, each leaf's four tensors of one shape, with a leading
    axis of M where a value is ``(M,)``), on the current stream, or
    raise."""
    if not leaves or leaves[0][0].device.type == "cpu":
        return adam_leaves_plain(leaves, lr, correction_1, correction_2)
    device = leaves[0][0].device
    if device.type != "cuda":
        raise ValueError(f"Adam's kernel runs on CUDA or CPU tensors, got {device}.")
    values = [_value(name, value, device) for (name, value) in
              (("lr", lr), ("correction_1", correction_1), ("correction_2", correction_2))]
    lengths = {length for (_, length) in values if length is not None}
    if len(lengths) > 1:
        raise ValueError(f"per-model values of lengths {sorted(lengths)}.")
    models = lengths.pop() if lengths else None
    for (index, leaf) in enumerate(leaves):
        _check_leaf(index, leaf, device, models)
    slices = models or 1
    outputs = [tuple(torch.empty_like(leaf[0]) for _ in range(3)) for leaf in leaves]
    sizes = [leaf[0].numel() // slices for leaf in leaves]
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    for (entries, blocks) in launch_plan(sizes, [slices] * len(leaves)):
        args = _Args(leaves=len(entries), lr=values[0][0], c1=values[1][0], c2=values[2][0],
                     b1=ADAM_B1, one_minus_b1=1 - ADAM_B1, b2=ADAM_B2,
                     one_minus_b2=1 - ADAM_B2, eps=ADAM_EPS)
        for (slot, (leaf, per_model, first)) in enumerate(entries):
            pointers = [t.data_ptr() for t in (*leaves[leaf], *outputs[leaf])]
            args.leaf[slot] = _Leaf(*pointers, sizes[leaf], per_model, first)
        status = lib.aeic_adam_f32(ctypes.byref(args), blocks, stream)
        gdn_kernel._raise_on_status(lib, status, "adam_f32")
        LAUNCHES["adam_f32"] += 1
        LAUNCH_SHAPES[(len(entries), slices)] += 1
    return outputs
