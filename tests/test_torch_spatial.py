"""PyTorch port: the height-sharded transforms (``parallel/spatial.py``)
and ``roundtrip_batched(mesh=, spatial=True)`` on one-process meshes of
CPU shards, against the unsharded port and against the JAX package's
``spatial=True`` on its 8-device CPU mesh (where GSPMD inserts the halo
exchanges). Tolerances: each band's conv within rtol 1e-5 / atol 1e-5 of
the whole image's; round trips within rtol 1e-4, atol 1e-4
(``tests/test_continuous_batching.py``); a 256 x 384 batch, the halo at
real geometry, within 5e-2 of a pixel level
(``__graft_entry__.py::dryrun_multichip``)."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import conv_eae as jax_conv_eae
from autoencoder_based_image_compression_tpu.parallel.inference import (
    roundtrip_batched as jax_roundtrip_batched,
)
from autoencoder_based_image_compression_tpu.parallel.mesh import make_mesh as jax_make_mesh
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.parallel import spatial
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    make_codec_fns,
    roundtrip_batched,
)
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_from_jax

needs_jax_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                    reason="needs the 8-device CPU platform")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's tensors, restored after: the
    tier-1 run puts six test processes on the machine's cores at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bands(x, nb_bands):
    height = x.shape[1] // nb_bands
    return {m: x[:, m * height:(m + 1) * height].contiguous() for m in range(nb_bands)}


def _local_exchange(nb_bands):
    return spatial.HaloExchange(make_mesh(nb_bands, devices=["cpu"] * nb_bands), 0)


def _jax_inputs(learn_bin_widths, shape=(4, 64, 64, 1), seed=3):
    params = jax_conv_eae.init_conv_eae_params(jax.random.PRNGKey(2), learn_bin_widths)
    images = numpy.random.default_rng(seed).integers(0, 256, size=shape).astype(numpy.uint8)
    return (params, params_from_jax({k: numpy.asarray(v) for (k, v) in params.items()}),
            images, numpy.ones(128, numpy.float32))


def test_tconv_halo_is_one_row_each_side():
    assert spatial.tconv_halo(9, 4) == (1, 1)
    assert spatial.tconv_halo(5, 2) == (1, 1)
    assert conv_eae.same_pads(9, 4) == (2, 3) and conv_eae.same_pads(5, 2) == (1, 2)


@pytest.mark.parametrize("nb_bands", [2, 4])
@pytest.mark.parametrize("kernel,stride,channels", [(9, 4, 1), (5, 2, 8)])
def test_band_convs_equal_the_whole_image_convs(nb_bands, kernel, stride, channels):
    generator = torch.Generator().manual_seed(kernel + nb_bands)
    x = torch.randn((2, 32 * nb_bands, 24, channels), generator=generator)
    w = torch.randn((6, channels, kernel, kernel), generator=generator)
    exchange = _local_exchange(nb_bands)
    got = spatial.conv_same_bands(_bands(x, nb_bands), w, stride, exchange)
    torch.testing.assert_close(torch.cat([got[m] for m in range(nb_bands)], dim=1),
                               conv_eae.conv_same(x, w, stride), rtol=1e-5, atol=1e-5)
    y = torch.randn((2, 8 * nb_bands, 6, 6), generator=generator)
    wt = torch.randn((6, 3, kernel, kernel), generator=generator)
    got = spatial.conv_transpose_same_bands(_bands(y, nb_bands), wt, stride, exchange)
    torch.testing.assert_close(torch.cat([got[m] for m in range(nb_bands)], dim=1),
                               conv_eae.conv_transpose_same(y, wt, stride), rtol=1e-5, atol=1e-5)


def test_halo_exchange_gives_neighbour_rows_and_zeros_at_the_edges():
    x = torch.arange(3 * 4, dtype=torch.float32).reshape(1, 12, 1, 1)
    halos = _local_exchange(3)(_bands(x, 3), 2, 1)
    assert halos[0][0].flatten().tolist() == [0.0, 0.0]
    assert halos[0][1].flatten().tolist() == [4.0]
    assert halos[1][0].flatten().tolist() == [2.0, 3.0]
    assert halos[2][1].flatten().tolist() == [0.0]
    with pytest.raises(ValueError, match="cannot lend"):
        _local_exchange(3)(_bands(x, 3), 5, 1)


@pytest.mark.parametrize("learn_bin_widths", [True, False])
@pytest.mark.parametrize("model", [2, 4])
def test_spatial_roundtrip_matches_the_unsharded_port(learn_bin_widths, model):
    (_, params, images, bin_widths) = _jax_inputs(learn_bin_widths)
    plain = roundtrip_batched(params, images, bin_widths, learn_bin_widths, 4, device="cpu")
    mesh = make_mesh(model, devices=["cpu"] * 8)
    sharded = roundtrip_batched(params, images, bin_widths, learn_bin_widths, 4, mesh=mesh,
                                spatial=True)
    numpy.testing.assert_allclose(sharded, plain, rtol=1e-4, atol=1e-4)


@needs_jax_mesh
@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_spatial_roundtrip_matches_the_jax_package(learn_bin_widths):
    (jax_params, params, images, bin_widths) = _jax_inputs(learn_bin_widths)
    expected = jax_roundtrip_batched(jax_params, images, bin_widths, learn_bin_widths,
                                     batch_size=4, mesh=jax_make_mesh(model_parallelism=2),
                                     spatial=True)
    got = roundtrip_batched(params, images, bin_widths, learn_bin_widths, 4,
                            mesh=make_mesh(2, devices=["cpu"] * 8), spatial=True)
    numpy.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def test_spatial_roundtrip_at_kodak_geometry():
    """A 256 x 384 batch in two bands: the 9x9 stride-4
    convs' halos are real here, unlike at 32 x 32."""
    (_, params, images, bin_widths) = _jax_inputs(True, shape=(2, 256, 384, 1), seed=5)
    plain = roundtrip_batched(params, images, bin_widths, True, 2, device="cpu")
    sharded = roundtrip_batched(params, images, bin_widths, True, 2,
                                mesh=make_mesh(2, devices=["cpu"] * 4), spatial=True)
    assert float(numpy.abs(sharded - plain).max()) < 5e-2


def test_fixed_bin_widths_fuse_gdn_and_quantiser_once_a_band(monkeypatch):
    calls = []
    fused = spatial.gdn_quantize_nhwc

    def counting(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return fused(x, *args, **kwargs)

    monkeypatch.setattr(spatial, "gdn_quantize_nhwc", counting)
    (_, params, images, bin_widths) = _jax_inputs(False)
    roundtrip_batched(params, images, bin_widths, False, 4,
                      mesh=make_mesh(2, devices=["cpu"] * 4), spatial=True)
    # (data=2, model=2): two images a data block, two bands an image.
    assert calls == [(2, 2, 4, csts.NB_MAPS_3)] * 4


def test_codec_fns_over_a_spatial_mesh_gather_the_whole_batch():
    (_, params, images, bin_widths) = _jax_inputs(True)
    mesh = make_mesh(2, devices=["cpu"] * 4)
    (encode_fn, decode_fn, put) = make_codec_fns(True, mesh, spatial=True)
    batch = put(images.astype(numpy.float32))
    assert sorted(batch.pieces) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    latents = encode_fn(params, batch)
    assert latents.global_shape == (4, 4, 4, 128)
    torch.testing.assert_close(latents.gather(), conv_eae.encode(
        params, torch.from_numpy(images.astype(numpy.float32)), True), rtol=1e-5, atol=1e-5)
    whole = decode_fn(params, latents, bin_widths).gather()
    numpy.testing.assert_allclose(whole.numpy(), roundtrip_batched(
        params, images, bin_widths, True, 4, device="cpu"), rtol=1e-4, atol=1e-4)
