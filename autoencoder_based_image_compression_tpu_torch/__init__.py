"""PyTorch/CUDA port of the entropy-autoencoder image codec.

Mirrors the module layout of ``autoencoder_based_image_compression_tpu``
(the JAX reference): a reader finds each counterpart under the same
name. Public functions keep the reference's layouts (NHWC activations,
``(..., C)`` for GDN, the same parameter names); entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

# The reference package's version: the port implements the same release.
__version__ = "0.1.0"
