"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
Asking for ``cuda`` without a card raises: nothing falls back to the
CPU silently.
"""

import torch


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
