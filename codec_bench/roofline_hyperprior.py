"""Operations of the scale hyperprior's training step, counted from
shapes (``configs/balle2018_hyperprior.json``), and the least time of its
GDN launches.

The count is of the model's work, as ``codec_bench/roofline.py`` counts
the EAE's: a conv's taps over its output grid, a transposed conv's over
its input grid, and the GDN pool's ``(rows, 128) @ (128, 128)``
product; elementwise work, the entropy models included, is left out. A
training step is the forward, and for every conv its weight gradient
and (except the first, whose input is the data) its input gradient,
each as many MACs as the forward; for every GDN site the pool's input
and weight gradients, two products of the forward's size. The layer
table is a frozen copy of the program's (``models/hyperprior.py``), so
that a change to the program cannot move the yardstick.
"""

from codec_bench import roofline

N = 128
M = 192
CHANNELS = 3

# (name, kind, scale of the grid its MACs are counted over against the
# image, input maps, output maps, kernel width, stride), in the
# program's order and names.
LAYERS = (
    ("ga_w1", "conv", 2, CHANNELS, N, 5, 2), ("ga_w2", "conv", 4, N, N, 5, 2),
    ("ga_w3", "conv", 8, N, N, 5, 2), ("ga_w4", "conv", 16, N, M, 5, 2),
    ("gs_w1", "tconv", 16, M, N, 5, 2), ("gs_w2", "tconv", 8, N, N, 5, 2),
    ("gs_w3", "tconv", 4, N, N, 5, 2), ("gs_w4", "tconv", 2, N, CHANNELS, 5, 2),
    ("ha_w1", "conv", 16, M, N, 3, 1), ("ha_w2", "conv", 32, N, N, 5, 2),
    ("ha_w3", "conv", 64, N, N, 5, 2),
    ("hs_w1", "tconv", 64, N, N, 5, 2), ("hs_w2", "tconv", 32, N, N, 5, 2),
    ("hs_w3", "tconv", 16, N, M, 3, 1),
)
# The GDN / IGDN sites: (name, scale of their grid against the image).
GDN_SITES = (("ga_gdn1", 2), ("ga_gdn2", 4), ("ga_gdn3", 8),
             ("gs_igdn1", 8), ("gs_igdn2", 4), ("gs_igdn3", 2))
FIRST = "ga_w1"


def layer_macs(height, width):
    """``{layer: MACs}`` of one ``height`` x ``width`` image's forward."""
    macs = {}
    for (name, _, scale, nb_in, nb_out, kernel, _) in LAYERS:
        macs[name] = (height // scale) * (width // scale) * kernel * kernel * nb_in * nb_out
    for (name, scale) in GDN_SITES:
        macs[name] = (height // scale) * (width // scale) * N * N
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


def gdn_sites(batch, height, width):
    """``[(rows, "fp32", 1)]`` of a step's forward GDN launches."""
    return [(batch * (height // scale) * (width // scale), "fp32", 1)
            for (_, scale) in GDN_SITES]


def gdn_bound_s(batch, height, width):
    """Least time of a step's GDN launches (``roofline.gdn_bound_s`` of
    each site)."""
    return roofline.gdn_sites_bound_s(gdn_sites(batch, height, width))
