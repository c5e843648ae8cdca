"""Operations of the joint autoregressive and hierarchical prior's training
step, counted from shapes (``configs/minnen2018_joint.json``), and the
least time of its GDN launches and of their gradients, at 192 channels.

The count is of the model's work, as ``codec_bench/roofline_hyperprior.py``
counts the hyperprior's: a conv's taps over its output grid, a
transposed conv's over its input grid, and the GDN pool's ``(rows,
192) @ (192, 192)`` product; elementwise work, the entropy models
included, is left out. The context model is a masked 5x5 conv: it
counts its 12 live taps, not 25 (the 13 masked ones multiply zeros,
which are no work of the model). A training step is the forward, and for
every conv its weight gradient and (except the first, whose input is the
data) its input gradient, each as many MACs as the forward; for every
GDN site the pool's input and weight gradients, two products of the
forward's size. The layer table is a frozen copy of the program's
(``models/minnen2018.py``), so that a change to the program cannot move
the yardstick.

The GDN bounds are ``codec_bench/roofline.py::gdn_bound_s``'s at C = 192
channels: a forward launch moves its input and output once at the HBM
rate or makes its ``2 * rows * C^2`` FLOPs at the fp32 peak, whichever
takes longer; its gradient (tile pass and reduction) reads ``x`` and the
incoming gradient and writes ``grad_x`` once, or makes three times the
forward's FLOPs (the pool again, ``t @ gamma^T`` and ``(x^2)^T t``).
"""

from codec_bench.roofline import PEAK_BYTES_PER_S, PEAK_FLOPS

N = 192
M = 192
CHANNELS = 3
GDN_CHANNELS = 192
CONTEXT_LIVE_TAPS = 12

# (name, kind, scale of the grid its MACs are counted over against the
# image, input maps, output maps, taps, stride), in the program's order
# and names; ``taps`` is the kernel's width squared, but for the masked
# context model its live taps.
LAYERS = (
    ("ga_w1", "conv", 2, CHANNELS, N, 25, 2), ("ga_w2", "conv", 4, N, N, 25, 2),
    ("ga_w3", "conv", 8, N, N, 25, 2), ("ga_w4", "conv", 16, N, M, 25, 2),
    ("gs_w1", "tconv", 16, M, N, 25, 2), ("gs_w2", "tconv", 8, N, N, 25, 2),
    ("gs_w3", "tconv", 4, N, N, 25, 2), ("gs_w4", "tconv", 2, N, CHANNELS, 25, 2),
    ("ha_w1", "conv", 16, M, N, 9, 1), ("ha_w2", "conv", 32, N, N, 25, 2),
    ("ha_w3", "conv", 64, N, N, 25, 2),
    ("hs_w1", "tconv", 64, N, M, 25, 2), ("hs_w2", "tconv", 32, M, 3 * M // 2, 25, 2),
    ("hs_w3", "conv", 16, 3 * M // 2, 2 * M, 9, 1),
    ("cm_w", "conv", 16, M, 2 * M, CONTEXT_LIVE_TAPS, 1),
    ("ep_w1", "conv", 16, 4 * M, 10 * M // 3, 1, 1),
    ("ep_w2", "conv", 16, 10 * M // 3, 8 * M // 3, 1, 1),
    ("ep_w3", "conv", 16, 8 * M // 3, 2 * M, 1, 1),
)
# The GDN / IGDN sites: (name, scale of their grid against the image).
GDN_SITES = (("ga_gdn1", 2), ("ga_gdn2", 4), ("ga_gdn3", 8),
             ("gs_igdn1", 8), ("gs_igdn2", 4), ("gs_igdn3", 2))
FIRST = "ga_w1"


def layer_macs(height, width):
    """``{layer: MACs}`` of one ``height`` x ``width`` image's forward."""
    macs = {}
    for (name, _, scale, nb_in, nb_out, taps, _) in LAYERS:
        macs[name] = (height // scale) * (width // scale) * taps * nb_in * nb_out
    for (name, scale) in GDN_SITES:
        macs[name] = (height // scale) * (width // scale) * GDN_CHANNELS * GDN_CHANNELS
    return macs


def forward_flops(height, width):
    return 2 * sum(layer_macs(height, width).values())


def train_flops(height, width):
    """FLOPs of one image in one training step, all fp32 (module
    docstring)."""
    total = 0
    for (name, value) in layer_macs(height, width).items():
        if name in dict(GDN_SITES):
            total += 3 * value
        else:
            total += value * (2 if name == FIRST else 3)
    return 2 * total


def site_rows(batch, height, width):
    """The rows of a step's GDN sites, one entry a launch."""
    return [batch * (height // scale) * (width // scale) for (_, scale) in GDN_SITES]


def gdn_bound_s(batch, height, width, channels=GDN_CHANNELS):
    """Least time of a step's forward GDN launches (module docstring)."""
    total = 0.0
    for rows in site_rows(batch, height, width):
        nbytes = (2 * rows * channels + channels * channels + channels) * 4
        flops = 2.0 * rows * channels * channels
        total += max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["fp32"])
    return total


def gdn_backward_bound_s(batch, height, width, channels=GDN_CHANNELS):
    """Least time of a step's GDN gradients, each site's tile pass and
    reduction together (module docstring)."""
    total = 0.0
    for rows in site_rows(batch, height, width):
        nbytes = (3 * rows * channels + 2 * (channels * channels + channels)) * 4
        flops = 3 * 2.0 * rows * channels * channels
        total += max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["fp32"])
    return total
