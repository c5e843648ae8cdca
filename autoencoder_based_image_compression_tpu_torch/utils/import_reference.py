"""Imports the reference's TF checkpoints into this package's layouts.

Counterpart of the reference package's ``utils/import_reference.py``. The
reference ships no trained weights, so reference parity needs either a
retraining or a weight importer; this is the importer.

Variable-name map (reference ``eae/graph/EntropyAutoencoder.py:108-230``):

    encoder/weights_{1..3}, biases_{1..3}, gamma_{1..3}, beta_{1..3}
    decoder/weights_{4..6}, biases_{4..5}, gamma_{4..6}, beta_{4..6}
    piecewise_linear_function/{bin_widths, parameters,
                               nb_intervals_per_side, grid}
    decaying_lr/global_step

TF stores conv kernels HWIO, the reference package's layout, so they go
through ``params_from_jax`` into this package's (OIHW, and ``(in, out,
kh, kw)`` for the transposed convs). The reference's live-sized density
``parameters`` embed into the fixed-capacity table centred at
``ppi * max_itvs``; ``grid`` is implied by the table geometry. The
tensors come back on the CPU. TensorFlow is imported only to read a
checkpoint file.
"""

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_from_jax

_ENCODER_KEYS = ["weights_1", "biases_1", "gamma_1", "beta_1",
                 "weights_2", "biases_2", "gamma_2", "beta_2",
                 "weights_3", "biases_3", "gamma_3", "beta_3"]
_DECODER_KEYS = ["gamma_4", "beta_4", "weights_4", "biases_4",
                 "gamma_5", "beta_5", "weights_5", "biases_5",
                 "gamma_6", "beta_6", "weights_6"]


def read_tf_checkpoint(path_to_ckpt):
    """Reads all variables of a TF checkpoint into {name: numpy array}."""
    from tensorflow.python.training import py_checkpoint_reader

    reader = py_checkpoint_reader.NewCheckpointReader(path_to_ckpt)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def import_reference_variables(variables, ppi=csts.NB_POINTS_PER_INTERVAL,
                               max_itvs=csts.MAX_ITVS_PER_SIDE):
    """A reference variable dict -> ``{"params", "density", "bin_widths",
    "step", "learn_bin_widths"}`` in this package's layouts.

    ``variables`` maps TF variable names (without the ``:0`` suffix) to
    numpy arrays, from :func:`read_tf_checkpoint` or an ``.npz`` exported
    elsewhere. The learned-vs-fixed-bin-width architecture is inferred
    from the presence of ``encoder/gamma_3``.
    """
    def get(name):
        if name not in variables:
            raise KeyError(f"reference checkpoint is missing variable {name!r}.")
        return numpy.asarray(variables[name], dtype=numpy.float32)

    learn_bin_widths = "encoder/gamma_3" not in variables
    reference = {}
    for (scope, keys, dropped) in (("encoder", _ENCODER_KEYS, ("gamma_3", "beta_3")),
                                   ("decoder", _DECODER_KEYS, ("gamma_4", "beta_4"))):
        for key in keys:
            if not (learn_bin_widths and key in dropped):
                reference[key] = get(f"{scope}/{key}")

    bin_widths = torch.from_numpy(get("piecewise_linear_function/bin_widths"))
    live_parameters = numpy.asarray(variables["piecewise_linear_function/parameters"],
                                    dtype=numpy.float32)
    nb_itvs = int(numpy.asarray(variables["piecewise_linear_function/nb_intervals_per_side"]))
    if nb_itvs > max_itvs:
        raise ValueError(
            f"checkpoint grid ({nb_itvs} intervals/side) exceeds the table "
            f"capacity ({max_itvs}); raise max_itvs.")
    expected_width = 2 * ppi * nb_itvs + 1
    if live_parameters.shape[1] != expected_width:
        raise ValueError(
            f"density parameters have width {live_parameters.shape[1]}, "
            f"expected {expected_width} for {nb_itvs} intervals/side.")

    # Embed the live table into the fixed-capacity table.
    center = ppi * max_itvs
    table = numpy.full((live_parameters.shape[0], dens.table_width(ppi, max_itvs)),
                       csts.LOW_PROJECTION, dtype=numpy.float32)
    table[:, center - ppi * nb_itvs:center + ppi * nb_itvs + 1] = live_parameters
    density = dens.DensityTable(parameters=torch.from_numpy(table),
                                nb_itvs_per_side=torch.tensor(nb_itvs, dtype=torch.int32))

    step = int(numpy.asarray(variables.get("decaying_lr/global_step", 0)))
    return {
        "params": params_from_jax(reference),
        "density": density,
        "bin_widths": bin_widths,
        "step": step,
        "learn_bin_widths": learn_bin_widths,
    }


def import_reference_checkpoint(path_to_ckpt, **kwargs):
    """TF checkpoint file -> the dict of :func:`import_reference_variables`."""
    return import_reference_variables(read_tf_checkpoint(path_to_ckpt), **kwargs)
