"""PyTorch port: the PSNR parity harness against the reference TF graph
(``<port>/eval/reference_parity.py``), against the reference package's
``eval/reference_parity.py``.

The first three tests mirror ``tests/test_reference_parity.py`` with the
port as "ours": they need TensorFlow and the reference sources and skip
without them. The others run anywhere: the guard agrees with the
reference package's, the port's side of the parity on the two trained
artifacts is held against one stand-in for the TF graph (the reference
package's fp32 round trip) shared by both modules, and the parameters
handed to the TF side are the reference package's, name for name and bit
for bit.
"""

import os

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.eval import reference_parity as jax_reference_parity
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.eval import reference_parity
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = [(0.5, True), (1.0, False)]
needs_reference = pytest.mark.skipif(
    not reference_parity.reference_available(),
    reason="reference kodak_tensorflow sources not available")


def _images(seed, nb=2, size=64):
    rng = numpy.random.default_rng(seed)
    return rng.integers(16, 236, size=(nb, size, size)).astype(numpy.uint8)


def _artifact(bw_init, learn_bw):
    return os.path.join(REPO, "results", "eae", experiment_suffix(bw_init, 10000.0, learn_bw),
                        "params_trained.npz")


@needs_reference
@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_e2e_psnr_parity_gate(learn_bin_widths):
    pytest.importorskip("tensorflow")
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(0), learn_bin_widths)
    bin_widths = numpy.full(128, 0.8, numpy.float32)
    report = reference_parity.measure_psnr_parity(params, bin_widths, _images(1),
                                                  learn_bin_widths, batch_size=2, device="cpu")
    assert report["max_abs_delta_db"] <= 0.05, report
    assert report["cross_psnr_db"] > 45.0, report


@needs_reference
def test_latents_match_reference_graph():
    pytest.importorskip("tensorflow")
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_to_jax

    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(2), True)
    images = _images(3, nb=1, size=48)[..., None].astype(numpy.float32)
    (y_ref, _) = reference_parity.reference_roundtrip_tf(
        params_to_jax(params), numpy.ones(128, numpy.float32), images, True)
    with torch.no_grad():
        y_ours = conv_eae.encode(params, torch.from_numpy(images), True).numpy()
    assert numpy.abs(y_ours - y_ref).max() < 1e-4 * numpy.abs(y_ref).max()


@needs_reference
@pytest.mark.parametrize("bw_init,learn_bw", TRAINED)
def test_e2e_psnr_parity_gate_trained_weights(bw_init, learn_bw):
    pytest.importorskip("tensorflow")
    (params_np, bin_widths) = load_params_artifact(_artifact(bw_init, learn_bw))
    images = synthetic_luminance_stack(2, 64, 64, seed=21)[..., 0]
    report = reference_parity.measure_psnr_parity(params_from_jax(params_np), bin_widths,
                                                  images, learn_bw, batch_size=2, device="cpu")
    assert report["max_abs_delta_db"] <= 0.05, report
    assert report["cross_psnr_db"] > 45.0, report


def test_reference_guard_agrees_with_the_jax_module():
    assert reference_parity.reference_available() == jax_reference_parity.reference_available()
    assert reference_parity._REF_ROOT == jax_reference_parity._REF_ROOT


def _jax_roundtrip(params_numpy, bin_widths, images_f32, learn_bin_widths):
    """Stands in for the TF graph: the reference package's fp32 encode ->
    quantise -> decode on the parameters the TF side would be given."""
    import jax.numpy as jnp

    from autoencoder_based_image_compression_tpu.models import conv_eae as jax_conv_eae

    params = {name: jnp.asarray(value) for (name, value) in params_numpy.items()}
    y = numpy.asarray(jax_conv_eae.encode(params, jnp.asarray(images_f32), learn_bin_widths))
    bw = bin_widths.reshape(1, 1, 1, -1)
    rec = jax_conv_eae.decode(params, jnp.asarray(bw * numpy.round(y / bw)), learn_bin_widths)
    return (y, numpy.asarray(rec))


@pytest.mark.parametrize("bw_init,learn_bw", TRAINED)
def test_port_side_of_the_parity_on_the_trained_artifacts(monkeypatch, bw_init, learn_bw):
    from autoencoder_based_image_compression_tpu.train.checkpoint import (
        load_params_artifact as jax_load_params_artifact,
    )

    monkeypatch.setattr(reference_parity, "reference_roundtrip_tf", _jax_roundtrip)
    monkeypatch.setattr(jax_reference_parity, "reference_roundtrip_tf", _jax_roundtrip)
    images = synthetic_luminance_stack(2, 64, 64, seed=21)[..., 0]
    (params_np, bin_widths) = load_params_artifact(_artifact(bw_init, learn_bw))
    report = reference_parity.measure_psnr_parity(params_from_jax(params_np), bin_widths,
                                                  images, learn_bw, batch_size=2, device="cpu")
    assert report["max_abs_delta_db"] <= 0.05, report
    assert report["cross_psnr_db"] > 45.0, report
    (params_jax, bin_widths_jax) = jax_load_params_artifact(_artifact(bw_init, learn_bw))
    expected = jax_reference_parity.measure_psnr_parity(
        params_jax, numpy.asarray(bin_widths_jax), images, learn_bw, batch_size=2)
    numpy.testing.assert_array_equal(report["psnrs_reference"], expected["psnrs_reference"])
    assert numpy.abs(report["psnrs_ours"] - expected["psnrs_ours"]).max() <= 0.05


@pytest.mark.parametrize("bw_init,learn_bw", TRAINED)
def test_tf_side_gets_the_jax_params_bit_for_bit(monkeypatch, bw_init, learn_bw):
    from autoencoder_based_image_compression_tpu.train.checkpoint import (
        load_params_artifact as jax_load_params_artifact,
    )

    handed = []

    def record(params_numpy, bin_widths, images_f32, learn_bin_widths):
        handed.append(params_numpy)
        return _jax_roundtrip(params_numpy, bin_widths, images_f32, learn_bin_widths)

    monkeypatch.setattr(reference_parity, "reference_roundtrip_tf", record)
    (params_np, bin_widths) = load_params_artifact(_artifact(bw_init, learn_bw))
    reference_parity.measure_psnr_parity(params_from_jax(params_np), bin_widths,
                                         _images(4), learn_bw, batch_size=2, device="cpu")
    (params_jax, _) = jax_load_params_artifact(_artifact(bw_init, learn_bw))
    (got,) = handed
    assert set(got) == set(params_jax)
    for (name, value) in params_jax.items():
        expected = numpy.asarray(value)
        assert isinstance(got[name], numpy.ndarray), name
        assert got[name].dtype == expected.dtype and got[name].shape == expected.shape, name
        assert got[name].tobytes() == expected.tobytes(), name


def test_device_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(0), True)
    with pytest.raises(RuntimeError, match="cuda"):
        reference_parity.measure_psnr_parity(params, numpy.ones(128, numpy.float32),
                                             _images(5), True, batch_size=2)
