"""Hyperparameter-to-path naming convention (reference
``kodak_tensorflow/tools/tools.py:570-593``)."""


def float_to_str(float_in):
    """Converts a float to a path-safe string.

    "." becomes "dot" for non-whole floats and "-" becomes "minus".
    """
    if float(float_in).is_integer():
        str_in = str(int(float_in))
    else:
        str_in = str(float_in).replace(".", "dot")
    return str_in.replace("-", "minus")
