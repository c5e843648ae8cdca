"""PyTorch port: the SVHN dataset side (``data/svhn.py`` and the ``svhn``
choice of ``cli/create_datasets``) against the JAX package's. All of it
is host code (numpy, scipy): on the same seed and the same ``.mat``
files both packages must give equal arrays, bit for bit."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import numpy
import pytest
import scipy.io

from autoencoder_based_image_compression_tpu.data import svhn as jax_svhn
from autoencoder_based_image_compression_tpu_torch.cli import create_datasets
from autoencoder_based_image_compression_tpu_torch.data import svhn


def _write_mats(folder, counts=(30, 20), seed=0):
    """SVHN-shaped ``.mat`` files: ``X`` is (32, 32, 3, N) uint8."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = numpy.random.default_rng(seed)
    for (name, count) in zip(("train_32x32.mat", "extra_32x32.mat"), counts):
        x = rng.integers(0, 256, size=(32, 32, 3, count)).astype(numpy.uint8)
        scipy.io.savemat(str(folder / name), {"X": x, "y": numpy.ones((count, 1))})
    return str(folder)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_svhn_equals_jax(seed):
    got = svhn.synthetic_svhn(50, seed=seed)
    assert got.shape == (50, 3072) and got.dtype == numpy.uint8
    numpy.testing.assert_array_equal(got, jax_svhn.synthetic_svhn(50, seed=seed))


@pytest.mark.parametrize("chunk", [7, 10000])
def test_preprocessing_equals_jax(chunk):
    rows = svhn.synthetic_svhn(23, seed=3)
    (mean, std) = svhn.compute_preprocessing_stats(rows, chunk=chunk)
    (jax_mean, jax_std) = jax_svhn.compute_preprocessing_stats(rows, chunk=chunk)
    numpy.testing.assert_array_equal(mean, jax_mean)
    assert std == jax_std and std.dtype == numpy.float32
    got = svhn.preprocess_svhn(rows, mean, std)
    numpy.testing.assert_array_equal(got, jax_svhn.preprocess_svhn(rows, mean, std))
    # Centred per pixel, unit global standard deviation.
    assert numpy.abs(got.mean(axis=0)).max() < 1e-4 and abs(float(got.std()) - 1.0) < 1e-4


def test_create_svhn_equals_jax(tmp_path, capsys):
    source = _write_mats(tmp_path / "mats")
    outputs = []
    for (tag, module) in (("port", svhn), ("jax", jax_svhn)):
        paths = [str(tmp_path / tag / f"{name}.npy") for name in ("train", "val", "test")]
        module.create_svhn(source, *paths, nb_training=30, nb_validation=10, nb_test=5, seed=4)
        outputs.append([numpy.load(p) for p in paths])
    for (got, expected) in zip(*outputs):
        assert got.dtype == numpy.uint8 and got.shape[1] == 3072
        numpy.testing.assert_array_equal(got, expected)
    assert [a.shape[0] for a in outputs[0]] == [30, 10, 5]
    # A second call keeps what is there.
    svhn.create_svhn(source, *[str(tmp_path / "port" / f"{n}.npy") for n in
                               ("train", "val", "test")], nb_training=1)
    assert "already exists" in capsys.readouterr().out


def test_create_svhn_refuses_too_few_digits(tmp_path):
    source = _write_mats(tmp_path / "mats", counts=(5, 5))
    paths = [str(tmp_path / f"{name}.npy") for name in ("train", "val", "test")]
    with pytest.raises(RuntimeError, match="Only 10 digits"):
        svhn.create_svhn(source, *paths, nb_training=20, nb_validation=1, nb_test=1)


def test_create_datasets_svhn_writes_the_jax_matrices(tmp_path):
    source = _write_mats(tmp_path / "mats", counts=(40, 40), seed=5)
    out = tmp_path / "out"
    create_datasets.main(["svhn", "--source_dir", source, "--out_dir", str(out),
                          "--nb_svhn_training", "50", "--nb_svhn_validation", "10",
                          "--nb_svhn_test", "8"])
    expected = [str(tmp_path / f"jax_{name}.npy") for name in ("train", "val", "test")]
    jax_svhn.create_svhn(source, *expected, nb_training=50, nb_validation=10, nb_test=8)
    for (name, path) in zip(("training_data", "validation_data", "test_data"), expected):
        numpy.testing.assert_array_equal(numpy.load(out / "svhn" / f"{name}.npy"),
                                         numpy.load(path))
