"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
Asking for ``cuda`` without a card raises: nothing falls back to the
CPU silently.
"""

import contextlib
import threading

import torch

# cuDNN's flags belong to the process: ``deterministic_cudnn`` counts the
# contexts open on any thread and restores the flag when the last leaves.
_DETERMINISTIC_LOCK = threading.Lock()
_deterministic_depth = 0
_deterministic_before = False


def disable_tf32():
    """Keeps fp32 convolutions and matmuls in true fp32 on the card.

    cuDNN runs fp32 convolutions in TF32 by default (about 2^-11
    relative error, enough to flip quantised symbols). The fp32 parity
    path and the fp32 stages of the serving path need true fp32: this is
    the card's counterpart of the reference's ``Precision.HIGHEST`` /
    ``HIGH`` pins, and at least as tight as either.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def deterministic_cudnn():
    """While open, cuDNN takes only algorithms that give the same bits
    on every run (``torch.backends.cudnn.deterministic``); the flag is
    put back on leaving.

    cuDNN's default algorithm for an fp32 transposed conv (its
    backward-data pass) sums with atomics, so two runs on the same input
    differ in the last bits. No serving or training call opens this
    context: the serving engine writes its first transposed conv as a
    forward conv (``engine/quantized.py::_tconv4_phases``), and the fp32
    parity transforms and training keep cuDNN's default (the
    deterministic algorithms cost 18 % of a training step's device work
    and 8x of an fp32 decode on an H100). Measurements that compare the
    two kinds of algorithm open it (``eval/kernel_probe.py``,
    ``chip_smoke.py``). The flag belongs to the process, not to a
    thread, so contexts may nest and may overlap across threads: the
    first to enter saves the flag and the last to leave puts it back,
    whatever the order in which they leave. While any is open, the other
    threads' convolutions take the deterministic algorithms too, and a
    CUDA graph captured meanwhile keeps them in every replay.
    """
    global _deterministic_depth, _deterministic_before
    with _DETERMINISTIC_LOCK:
        if _deterministic_depth == 0:
            _deterministic_before = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
        _deterministic_depth += 1
    try:
        yield
    finally:
        with _DETERMINISTIC_LOCK:
            _deterministic_depth -= 1
            if _deterministic_depth == 0:
                torch.backends.cudnn.deterministic = _deterministic_before


def resolve_device(device="cuda"):
    """Returns ``torch.device(device)``; raises if it is a missing card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU.")
        disable_tf32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (use 'cuda' or 'cpu').")
    return device
