"""Trained-parameter artifacts and their conversion to PyTorch layouts.

``params_trained.npz`` holds ``param:<name>`` arrays in the reference's
layouts, ``bin_widths`` and ``step``. Loading is numpy-only;
:func:`params_from_jax` carries the arrays into the port's layouts.
"""

import numpy
import torch

CONV_NAMES = ("weights_1", "weights_2", "weights_3", "weights_4", "weights_5",
              "weights_6")


def load_params_artifact(path_npz):
    """Loads a params artifact.

    Returns ``(params, bin_widths)``: a dict of numpy arrays in the
    reference's layouts and the float32 bin widths.
    """
    with numpy.load(path_npz) as data:
        params = {key[len("param:"):]: numpy.asarray(data[key])
                  for key in data.files if key.startswith("param:")}
        bin_widths = numpy.asarray(data["bin_widths"], numpy.float32)
    return (params, bin_widths)


def params_from_jax(params_np):
    """Reference-layout numpy params -> dict of float32 CPU tensors.

    - Encoder kernels are HWIO; ``permute(3, 2, 0, 1)`` gives OIHW.
    - Decoder kernels are stored ``(kh, kw, tconv_out, tconv_in)``, the
      HWIO layout of the forward conv they transpose. The same permute
      gives ``conv_transpose2d``'s ``(in, out, kh, kw)``; no spatial
      flip is needed, because ``conv_transpose2d`` is already the
      adjoint of ``conv2d`` with the same weight.
    - GDN ``gamma`` is ``(C, C)`` indexed ``[k, c]`` and stays as it is;
      biases and betas are ``(C,)``.
    """
    params = {}
    for (name, value) in params_np.items():
        tensor = torch.from_numpy(numpy.array(value, dtype=numpy.float32))
        if name in CONV_NAMES:
            tensor = tensor.permute(3, 2, 0, 1).contiguous()
        params[name] = tensor
    return params
