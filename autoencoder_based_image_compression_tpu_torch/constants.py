"""Architecture and optimiser constants of the conv entropy autoencoder.

Same values as the reference codec's
(``kodak_tensorflow/eae/graph/constants.py``): 3 layers of 128 maps,
kernels 9/5/5, strides 4/2/2; Adam on the autoencoder, plain SGD on the
density table and on the bin widths.
"""

# Learning rate of the entropy-autoencoder parameters (Adam).
LR_EAE = 1.0e-4

# Learning rate of the piecewise-linear density parameters (SGD).
LR_FCT = 0.2

# Learning rate of the quantisation bin widths (SGD).
LR_BW = 2.0e-8

# Weight of the l2-norm weight decay in the rate-distortion objective.
WEIGHT_DECAY_P = 5.0e-4

# Lower projection bound for GDN/IGDN weights and additive coefficients.
MIN_GAMMA_BETA = 2.0e-5

# Projection interval for the quantisation bin widths.
MIN_BW = 0.8
MAX_BW = 4.0

# Number of unit intervals in the right half of the density grid at the
# beginning of the first training.
NB_ITVS_PER_SIDE_INIT = 10

# Number of sampling points per unit interval in the density grid.
NB_POINTS_PER_INTERVAL = 5

# Strictly positive floor for the piecewise-linear density parameters:
# keeps limited floating-point precision from rounding them to 0.
LOW_PROJECTION = 1.0e-6

NB_MAPS_1 = 128
NB_MAPS_2 = 128
NB_MAPS_3 = 128
WIDTH_KERNEL_1 = 9
WIDTH_KERNEL_2 = 5
WIDTH_KERNEL_3 = 5
STRIDE_1 = 4
STRIDE_2 = 2
STRIDE_3 = 2

# Product of the three strides: input images must have height and width
# divisible by `STRIDE_PROD`; latent maps are `STRIDE_PROD`x smaller.
STRIDE_PROD = STRIDE_1 * STRIDE_2 * STRIDE_3

# The conv kernels of the parameter dict: the leaves whose layout differs
# from the reference's on disk, and the ones under weight decay.
CONV_NAMES = ("weights_1", "weights_2", "weights_3", "weights_4", "weights_5",
              "weights_6")

# Capacity of the density table, in unit intervals per side. The table
# is allocated at this size once; the live extent is a scalar tensor on
# the device (`nb_itvs_per_side`) and the cells outside it are pinned at
# `LOW_PROJECTION`, so growing the grid moves a scalar and no training
# step has to ask the host for a new shape.
MAX_ITVS_PER_SIDE = 64


def lr_boundaries(gamma_scaling):
    """The two global-step boundaries of the piecewise-constant
    learning-rate schedule of the autoencoder's parameters, keyed on the
    entropy scaling coefficient gamma
    (reference ``EntropyAutoencoder.py:235-243``)."""
    if gamma_scaling < 60000.0:
        return (1500000, 2000000)
    if gamma_scaling < 80000.0:
        return (900000, 950000)
    return (750000, 800000)
