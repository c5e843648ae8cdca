"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy in fp32, TF32 off, written from the paper's
equations and the codec's specification (Dumas, Roumy, Guillemot,
ICASSP 2018; the reference repository's ``kodak_tensorflow``). It
imports neither JAX, nor the JAX package, nor anything of the port, and
takes nothing the port made: it loads the committed parameters and
statistics itself, makes its own density table and works out every
quantity again from the inputs the benchmark hands both sides.

- :mod:`.codec`: the analysis and synthesis transforms with GDN / IGDN,
  the per-map quantiser, the BT.601 cast;
- :mod:`.rate`: the exact length of the UEG0 arithmetic code of each
  latent map, and the exception map's entropy cost;
- :mod:`.training`: the density model and the three-optimiser training
  step of one model (a ladder is its models, each stepped alone).
"""

import torch


def plain_fp32():
    """True fp32 on the card: TF32 off in both switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32():
    """TF32 on in both switches: the control's precision, one step below
    the true fp32 the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
