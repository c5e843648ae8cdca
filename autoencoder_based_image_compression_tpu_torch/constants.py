"""Architecture constants of the conv entropy autoencoder.

Same values as the reference codec's
(``kodak_tensorflow/eae/graph/constants.py``): 3 layers of 128 maps,
kernels 9/5/5, strides 4/2/2.
"""

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
