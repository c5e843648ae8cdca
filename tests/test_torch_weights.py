"""PyTorch port: trained weights carried across from the JAX layouts.

Both committed artifacts load through the port's numpy loader and
``params_from_jax``; single convs and transposed convs on those weights
match the JAX package's.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import conv_eae as jax_eae
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = {
    "learning_bw": os.path.join(REPO, "results", "eae", "learning_bw",
                                "0dot5_10000", "params_trained.npz"),
    "fixed_bw": os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000",
                             "params_trained.npz"),
}


@pytest.mark.parametrize("variant", sorted(ARTIFACTS))
def test_params_from_jax_counts_and_layouts(variant):
    (params_np, bin_widths) = load_params_artifact(ARTIFACTS[variant])
    params = params_from_jax(params_np)
    (params_jax, bin_widths_jax) = jax_load_params_artifact(ARTIFACTS[variant])
    assert sum(p.numel() for p in params.values()) == jax_eae.nb_parameters(params_jax)
    assert set(params) == set(params_jax)
    numpy.testing.assert_array_equal(bin_widths, numpy.asarray(bin_widths_jax))
    assert ("gamma_3" in params) == (variant == "fixed_bw")
    for (name, value) in params.items():
        assert value.dtype == torch.float32 and value.device.type == "cpu"
        if name.startswith("weights_"):
            # HWIO (encoder) / (kh, kw, tconv_out, tconv_in) (decoder) -> OIHW.
            (kh, kw, i, o) = params_jax[name].shape
            assert tuple(value.shape) == (o, i, kh, kw)
            assert value.is_contiguous()
        else:
            numpy.testing.assert_array_equal(value.numpy(), numpy.asarray(params_jax[name]))


@pytest.mark.parametrize("name,stride,transpose", [
    ("weights_1", 4, False), ("weights_2", 2, False), ("weights_3", 2, False),
    ("weights_4", 2, True), ("weights_5", 2, True), ("weights_6", 4, True)])
def test_single_conv_matches_jax(name, stride, transpose):
    (params_np, _) = load_params_artifact(ARTIFACTS["learning_bw"])
    params = params_from_jax(params_np)
    w_jax = jnp.asarray(params_np[name])
    (_, _, in_jax, out_jax) = params_np[name].shape
    rng = numpy.random.default_rng(int(name[-1]))
    if transpose:
        x = rng.normal(size=(2, 6, 5, out_jax)).astype(numpy.float32)
        expected = jax_eae.conv_transpose_same(jnp.asarray(x), w_jax, stride)
        got = conv_eae.conv_transpose_same(torch.from_numpy(x), params[name], stride)
    else:
        x = rng.normal(size=(2, 24, 20, in_jax)).astype(numpy.float32)
        expected = jax_eae._conv_same(jnp.asarray(x), w_jax, stride)
        got = conv_eae.conv_same(torch.from_numpy(x), params[name], stride)
    assert tuple(got.shape) == tuple(expected.shape)
    # fp32 on both sides; only the summation order differs.
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(expected),
                                  rtol=1e-5, atol=1e-5)
