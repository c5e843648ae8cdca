"""Hyperparameter-to-path naming convention (reference
``kodak_tensorflow/tools/tools.py:570-593``)."""

import os


def float_to_str(float_in):
    """Converts a float to a path-safe string.

    "." becomes "dot" for non-whole floats and "-" becomes "minus".
    """
    if float(float_in).is_integer():
        str_in = str(int(float_in))
    else:
        str_in = str(float_in).replace(".", "dot")
    return str_in.replace("-", "minus")


def experiment_suffix(bin_width_init, gamma_scaling, learn_bin_widths):
    """Experiment directory suffix: ``learning_bw/<bw>_<gamma>`` or
    ``fixed_bw/<bw>_<gamma>`` (reference ``training_eae_imagenet.py:75-96``)."""
    kind = "learning_bw" if learn_bin_widths else "fixed_bw"
    return os.path.join(kind, f"{float_to_str(bin_width_init)}_{float_to_str(gamma_scaling)}")
