"""PyTorch port: the reference-checkpoint importer
(``utils/import_reference.py``) against the JAX package's, on the
reference-named dicts of ``tests/test_import_reference.py`` and on a TF
checkpoint the test writes itself. Equal arrays are required (the
importer only renames, permutes and embeds); the imported models then
decode within rtol 1e-5 / atol 1e-4 of the JAX package's decode."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import conv_eae as jconv
from autoencoder_based_image_compression_tpu.utils import import_reference as jax_import
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_to_jax
from autoencoder_based_image_compression_tpu_torch.utils import import_reference

import test_import_reference as jax_tests

ARCHS = pytest.mark.parametrize("learned", [True, False], ids=["learned", "fixed"])


def _assert_imports_equal(got, expected):
    assert got["learn_bin_widths"] == expected["learn_bin_widths"]
    assert got["step"] == expected["step"]
    params = params_to_jax(got["params"])
    assert set(params) == set(expected["params"])
    for (name, value) in expected["params"].items():
        numpy.testing.assert_array_equal(params[name], numpy.asarray(value), err_msg=name)
    numpy.testing.assert_array_equal(got["bin_widths"].numpy(),
                                     numpy.asarray(expected["bin_widths"]))
    numpy.testing.assert_array_equal(got["density"].parameters.numpy(),
                                     numpy.asarray(expected["density"].parameters))
    assert int(got["density"].nb_itvs_per_side) == int(expected["density"].nb_itvs_per_side)
    assert got["density"].nb_itvs_per_side.dtype == torch.int32


@ARCHS
def test_import_reference_variables_equals_jax(learned):
    variables = jax_tests._fake_reference_variables(learn_bin_widths=learned)
    got = import_reference.import_reference_variables(variables, ppi=5, max_itvs=32)
    _assert_imports_equal(got, jax_import.import_reference_variables(variables, ppi=5,
                                                                     max_itvs=32))
    assert ("gamma_3" in got["params"]) == (not learned)
    # This package's layouts: OIHW encoder kernels, (in, out, kh, kw)
    # decoder kernels.
    assert got["params"]["weights_1"].shape == (128, 1, 9, 9)
    assert got["params"]["weights_6"].shape == (128, 1, 9, 9)
    table = got["density"].parameters.numpy()
    assert table[0, 0] == numpy.float32(csts.LOW_PROJECTION)


@ARCHS
def test_imported_model_decodes_as_jax(learned):
    variables = jax_tests._fake_reference_variables(learn_bin_widths=learned, nb_maps=128)
    for name in variables:  # keep the fake kernels' activations in range
        if "/weights_" in name:
            variables[name] = 0.02 * variables[name]
    got = import_reference.import_reference_variables(variables, ppi=5, max_itvs=32)
    expected = jax_import.import_reference_variables(variables, ppi=5, max_itvs=32)
    y = numpy.random.default_rng(1).normal(0, 2, size=(1, 2, 3, 128)).astype(numpy.float32)
    with torch.no_grad():
        decoded = conv_eae.decode(got["params"], torch.from_numpy(y), learned).numpy()
    numpy.testing.assert_allclose(decoded, numpy.asarray(
        jconv.decode(expected["params"], jnp.asarray(y), learned)), rtol=1e-5, atol=1e-4)


def test_import_refuses_what_jax_refuses():
    oversized = jax_tests._fake_reference_variables(learn_bin_widths=True, nb_itvs=40)
    with pytest.raises(ValueError, match="exceeds the table"):
        import_reference.import_reference_variables(oversized, ppi=5, max_itvs=32)
    variables = jax_tests._fake_reference_variables(learn_bin_widths=True)
    variables["piecewise_linear_function/nb_intervals_per_side"] = numpy.asarray(11)
    with pytest.raises(ValueError, match="expected 111"):
        import_reference.import_reference_variables(variables, ppi=5, max_itvs=32)
    del variables["decoder/weights_6"]
    with pytest.raises(KeyError, match="decoder/weights_6"):
        import_reference.import_reference_variables(variables, ppi=5, max_itvs=32)


def test_import_real_tf_checkpoint_equals_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    variables = jax_tests._fake_reference_variables(learn_bin_widths=False, nb_maps=8)
    path = str(tmp_path / "model_1.ckpt")
    graph = tf1.Graph()
    with graph.as_default():
        for (name, value) in variables.items():
            (scope, var) = name.split("/")
            with tf1.variable_scope(scope, reuse=tf1.AUTO_REUSE):
                tf1.get_variable(var, initializer=tf1.constant(value))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, path)
    read = import_reference.read_tf_checkpoint(path)
    assert set(read) == set(variables)
    got = import_reference.import_reference_checkpoint(path, ppi=5, max_itvs=32)
    _assert_imports_equal(got, jax_import.import_reference_checkpoint(path, ppi=5,
                                                                      max_itvs=32))
    numpy.testing.assert_array_equal(params_to_jax(got["params"])["weights_1"],
                                     variables["encoder/weights_1"])
