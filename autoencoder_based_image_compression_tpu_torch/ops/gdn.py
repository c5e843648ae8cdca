"""Generalized Divisive Normalization, plain PyTorch versions.

    gdn(x)_c  = x_c / sqrt(sum_k gamma[k, c] * x_k^2 + beta_c)
    igdn(x)_c = x_c * sqrt(sum_k gamma[k, c] * x_k^2 + beta_c)

These define what the hand-written kernels of
``ops/kernels/gdn_kernel.py`` must compute; the kernel wrappers run them
for tensors that lie on the CPU. Counterpart of the reference's
``ops/gdn.py``.
"""

import torch


def _norm_pool(x, gamma, beta):
    """``sum_k gamma[k, c] * x_k^2 + beta_c`` over the trailing axis, fp32.

    On the card the matmul runs in true fp32 (TF32 is off, see
    ``utils.device.disable_tf32``).
    """
    return torch.matmul(torch.square(x), gamma) + beta


def gdn(x, gamma, beta):
    """Forward GDN on ``(..., C)`` fp32 activations."""
    return x * torch.rsqrt(_norm_pool(x, gamma, beta))


def inverse_gdn(x, gamma, beta):
    """Inverse GDN on ``(..., C)`` fp32 activations."""
    return x * torch.sqrt(_norm_pool(x, gamma, beta))


def gdn_lowp(x, gamma, beta, inverse=False):
    """GDN/IGDN in the low-precision dtype of ``x`` (bf16).

    The square is taken in bf16 (so it is rounded to bf16) and gamma is
    rounded to bf16; their products are exact in fp32, the pool
    accumulates in fp32, sqrt/rsqrt and the scaling run in fp32 and the
    result is rounded to ``x``'s dtype. This is the reference's
    ``gdn_lowp``: bf16 MXU operands with fp32 accumulation.
    """
    squares = (x * x).to(torch.float32)
    pool = torch.matmul(squares, gamma.to(x.dtype).to(torch.float32)) + beta
    scale = torch.sqrt(pool) if inverse else torch.rsqrt(pool)
    return (x.to(torch.float32) * scale).to(x.dtype)


def init_gdn_gamma(generator, nb_maps, min_gamma=2.0e-5, max_gamma=0.01):
    """Symmetric uniform init of the GDN weights: U(min_gamma, max_gamma),
    then symmetrised. Drawn from ``generator`` on its device.

    Raises ``ValueError`` if ``min_gamma`` does not belong to ]0., 0.01].
    """
    if min_gamma > 0.01 or min_gamma <= 0.0:
        raise ValueError("`min_gamma` does not belong to ]0., 0.01].")
    raw = torch.rand((nb_maps, nb_maps), generator=generator, device=generator.device,
                     dtype=torch.float32)
    raw = min_gamma + (max_gamma - min_gamma) * raw
    return 0.5 * (raw + raw.t())
