"""Operations and bytes of the codec's work, counted from shapes, and the
published peaks of one NVIDIA H100 SXM they are held against.

Frozen copies, so that a later change to the program cannot move the
yardstick: :func:`conv_eae_flops` is the port's
``eval/roofline.py::conv_eae_flops`` (extended here to a training step),
:func:`gdn_bound_s` is ``chip_smoke.py::bound`` in seconds.

The count is of the model's work, whatever implements it: a conv's taps
over its output (the space-to-depth and phase forms the program runs
compute zeros besides, which do not count), and the GDN pool's
``(rows, 128) @ (128, 128)`` product. Elementwise work is left out.
"""

# NVIDIA's H100 SXM data sheet, dense, at the card's full 700 W.
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

NB_MAPS = 128

# The layers of the transforms in order: (name, kind, scale of the
# layer's output grid against the image, input maps, output maps,
# kernel width). A transposed conv's MACs are counted over its input
# grid (its scale here), a conv's over its output grid.
LAYERS = (
    ("conv_1", "conv", 4, 1, NB_MAPS, 9),
    ("gdn_1", "gdn", 4, NB_MAPS, NB_MAPS, 0),
    ("conv_2", "conv", 8, NB_MAPS, NB_MAPS, 5),
    ("gdn_2", "gdn", 8, NB_MAPS, NB_MAPS, 0),
    ("conv_3", "conv", 16, NB_MAPS, NB_MAPS, 5),
    ("gdn_3", "gdn", 16, NB_MAPS, NB_MAPS, 0),
    ("igdn_4", "gdn", 16, NB_MAPS, NB_MAPS, 0),
    ("tconv_4", "tconv", 16, NB_MAPS, NB_MAPS, 5),
    ("igdn_5", "gdn", 8, NB_MAPS, NB_MAPS, 0),
    ("tconv_5", "tconv", 8, NB_MAPS, NB_MAPS, 5),
    ("igdn_6", "gdn", 4, NB_MAPS, NB_MAPS, 0),
    ("tconv_6", "tconv", 4, NB_MAPS, 1, 9),
)
ENCODER = ("conv_1", "gdn_1", "conv_2", "gdn_2", "conv_3", "gdn_3")
# Present only with fixed bin widths (the bottleneck pair).
BOTTLENECK = ("gdn_3", "igdn_4")


def layers(learn_bin_widths):
    """The model's layers, without the bottleneck pair when the bin
    widths are learned."""
    return [layer for layer in LAYERS
            if not (learn_bin_widths and layer[0] in BOTTLENECK)]


def layer_macs(height, width, learn_bin_widths):
    """``{layer: MACs}`` of one ``height`` x ``width`` image."""
    macs = {}
    for (name, kind, scale, nb_in, nb_out, kernel) in layers(learn_bin_widths):
        pixels = (height // scale) * (width // scale)
        if kind == "gdn":
            macs[name] = pixels * nb_in * nb_out
        else:
            macs[name] = pixels * kernel * kernel * nb_in * nb_out
    return macs


def conv_eae_flops(height, width, learn_bin_widths=True):
    """FLOPs (2 x MACs) of one image through encoder and decoder."""
    return 2 * sum(layer_macs(height, width, learn_bin_widths).values())


def serve_flops(height, width, learn_bin_widths, bf16_layers=()):
    """``{"fp32": F, "bf16": G}`` FLOPs of one image's round trip, each
    layer at the dtype its path computes it in (``bf16_layers`` on the
    tensor cores, the rest fp32 on the CUDA cores)."""
    flops = {"fp32": 0, "bf16": 0}
    for (name, macs) in layer_macs(height, width, learn_bin_widths).items():
        flops["bf16" if name in bf16_layers else "fp32"] += 2 * macs
    return flops


def train_flops(height, width, learn_bin_widths):
    """FLOPs of one image in one training step, all fp32.

    The density phase's encoder forward without grad, then the
    autoencoder phase: the forward, and for every conv its weight
    gradient and (except ``conv_1``, whose input is the data) its input
    gradient, each as many MACs as the forward; for every GDN site the
    pool's input and weight gradients, two products of the forward's
    size."""
    macs = layer_macs(height, width, learn_bin_widths)
    total = sum(macs[name] for name in ENCODER if name in macs)
    for (name, value) in macs.items():
        if name.startswith(("conv", "tconv")):
            total += value * (2 if name == "conv_1" else 3)
        else:
            total += 3 * value
    return 2 * total


def least_time_s(flops):
    """The least time the published peaks allow for ``{"fp32": F,
    "bf16": G}`` FLOPs."""
    return sum(value / PEAK_FLOPS[dtype] for (dtype, value) in flops.items())


def gdn_bound_s(rows, dtype, quantize=False, models=1):
    """Least time (s) of one GDN kernel launch and what sets it: each
    input read once and the output written once at the HBM rate, or the
    ``2 * rows * 128^2`` FLOPs of the pool at the peak of its dtype
    (``rows`` a model, ``models`` models for the stacked kernel)."""
    nbytes = 2 * rows * models * NB_MAPS * (4 if dtype == "fp32" else 2)
    nbytes += models * (NB_MAPS * NB_MAPS + NB_MAPS + (NB_MAPS if quantize else 0)) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2.0 * rows * models * NB_MAPS * NB_MAPS / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def gdn_sites(learn_bin_widths, batch, height, width, names, bf16_layers=(), models=1):
    """``[(rows, dtype, models)]`` of the GDN sites ``names`` of one call
    on ``batch`` images of ``height`` x ``width``."""
    scales = {layer[0]: layer[2] for layer in layers(learn_bin_widths)}
    return [(batch * (height // scales[name]) * (width // scales[name]),
             "bf16" if name in bf16_layers else "fp32", models)
            for name in names if name in scales]


def gdn_sites_bound_s(sites):
    """Least time of the GDN launches ``sites`` (:func:`gdn_sites`)."""
    return sum(gdn_bound_s(rows, dtype, models=models)[0] for (rows, dtype, models) in sites)


def serve_gdn_sites(learn_bin_widths, batch, height, width, bf16_layers=()):
    """The GDN launches of one serving unit: every site of the round trip."""
    names = [layer[0] for layer in layers(learn_bin_widths) if layer[1] == "gdn"]
    return gdn_sites(learn_bin_widths, batch, height, width, names, bf16_layers)


def train_gdn_sites(learn_bin_widths, batch, height, width, models=1):
    """The forward GDN launches of one training step: the density phase's
    encoder, then the autoencoder phase's encoder and decoder (the
    backward is plain PyTorch, no kernel of its own)."""
    gdn = [layer[0] for layer in layers(learn_bin_widths) if layer[1] == "gdn"]
    encoder = [name for name in gdn if name in ENCODER]
    return gdn_sites(learn_bin_widths, batch, height, width, encoder + gdn, models=models)
