"""PyTorch port: the dataset creators, the gated download helpers, the
``create_datasets`` command line and the host image utilities against the
JAX package's. All of it is host code (numpy, Pillow): on the same
generated image folders and the same random inputs the two packages must
give equal arrays. No test touches the network: the fetcher is a fake.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import io
import os
import pickle
import tarfile

import numpy
import PIL.Image
import pytest

from autoencoder_based_image_compression_tpu.data import bsds as jax_bsds
from autoencoder_based_image_compression_tpu.data import imagenet as jax_imagenet
from autoencoder_based_image_compression_tpu.data import kodak as jax_kodak
from autoencoder_based_image_compression_tpu.utils import image as jax_image
from autoencoder_based_image_compression_tpu_torch.cli import create_datasets
from autoencoder_based_image_compression_tpu_torch.data import (
    bsds,
    download,
    imagenet,
    kodak,
)
from autoencoder_based_image_compression_tpu_torch.utils import image


def _write_images(folder, shapes, extension, seed=0):
    folder.mkdir(parents=True, exist_ok=True)
    rng = numpy.random.default_rng(seed)
    for (i, shape) in enumerate(shapes):
        rgb = rng.integers(0, 256, size=shape).astype(numpy.uint8)
        PIL.Image.fromarray(rgb.squeeze()).save(folder / f"image_{i:03d}.{extension}")
    return str(folder)


def _both(tmp_path, build, names):
    """Runs ``build(module_index, paths)`` for the port and the JAX
    package and returns the files each wrote."""
    outputs = []
    for index in (0, 1):
        paths = [str(tmp_path / f"{index}_{name}") for name in names]
        build(index, paths)
        outputs.append(paths)
    return outputs


def _load(path):
    if path.endswith(".pkl"):
        with open(path, "rb") as file:
            return pickle.load(file)
    return numpy.load(path)


def test_create_kodak_equals_jax(tmp_path, capsys):
    shapes = [(512, 768, 3) if i % 3 else (768, 512, 3) for i in range(24)]
    source = _write_images(tmp_path / "pngs", shapes, "png")
    (ours, theirs) = _both(
        tmp_path, lambda i, paths: (kodak, jax_kodak)[i].create_kodak(source, *paths),
        ["kodak.npy", "list_rotation.pkl"])
    stack = _load(ours[0])
    assert stack.shape == (24, 512, 768) and stack.dtype == numpy.uint8
    numpy.testing.assert_array_equal(stack, _load(theirs[0]))
    assert _load(ours[1]) == _load(theirs[1]) == [i for i in range(24) if i % 3 == 0]
    kodak.create_kodak(source, *ours)  # idempotent
    assert "already exists" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="Expected 24"):
        kodak.create_kodak(str(tmp_path), str(tmp_path / "k.npy"), str(tmp_path / "r.pkl"))


def test_create_bsds_equals_jax(tmp_path):
    shapes = [(321, 481, 3) if i % 4 else (481, 321, 3) for i in range(100)]
    source = _write_images(tmp_path / "jpgs", shapes, "jpg")
    (ours, theirs) = _both(
        tmp_path, lambda i, paths: (bsds, jax_bsds)[i].create_bsds(source, *paths),
        ["bsds.npy", "list_rotation.pkl"])
    stack = _load(ours[0])
    assert stack.shape == (100, 320, 480)
    numpy.testing.assert_array_equal(stack, _load(theirs[0]))
    assert _load(ours[1]) == _load(theirs[1]) == list(range(0, 100, 4))
    with pytest.raises(RuntimeError, match="Expected 100"):
        bsds.create_bsds(str(tmp_path), str(tmp_path / "b.npy"), str(tmp_path / "r.pkl"))


def test_create_imagenet_training_and_extra_equal_jax(tmp_path):
    # One image is too small and one is greyscale: both are skipped.
    shapes = [(40 + i, 52, 3) for i in range(8)] + [(20, 20, 3), (48, 48, 1)]
    source = _write_images(tmp_path / "images", shapes, "png", seed=1)

    def build(i, paths):
        module = (imagenet, jax_imagenet)[i]
        module.create_imagenet_training(source, paths[0], paths[1], nb_training=5,
                                        nb_validation=2, width_crop=32)
        module.create_extra([source], paths[2], nb_extra=6, width_crop=32)

    (ours, theirs) = _both(tmp_path, build, ["training.npy", "validation.npy", "extra.npy"])
    for (path, path_j, count) in zip(ours, theirs, (5, 2, 6)):
        assert _load(path).shape == (count, 32, 32, 1) and _load(path).dtype == numpy.uint8
        numpy.testing.assert_array_equal(_load(path), _load(path_j))
    with pytest.raises(RuntimeError, match="usable images"):
        imagenet.create_imagenet_training(source, str(tmp_path / "t.npy"),
                                          str(tmp_path / "v.npy"), 9, 2, 32)
    with pytest.raises(RuntimeError, match="usable images"):
        imagenet.create_extra([source], str(tmp_path / "e.npy"), nb_extra=9, width_crop=32)


def test_download_file_with_and_without_a_fetcher(tmp_path):
    destination = str(tmp_path / "sub" / "file.bin")
    with pytest.raises(download.DownloadRequired, match="--download"):
        download.download_file("http://example.invalid/file.bin", destination, False)
    calls = []

    def fake_fetch(url, dest):
        calls.append(url)
        with open(dest, "wb") as file:
            file.write(b"payload")

    assert download.download_file("http://example.invalid/file.bin", destination, True,
                                  fetcher=fake_fetch) is True
    assert download.download_file("http://example.invalid/file.bin", destination, True,
                                  fetcher=fake_fetch) is False
    assert calls == ["http://example.invalid/file.bin"]

    def broken_fetch(url, dest):
        with open(dest, "wb") as file:
            file.write(b"par")
        raise OSError("connection lost")

    partial = str(tmp_path / "partial.bin")
    with pytest.raises(OSError):
        download.download_file("http://example.invalid/x", partial, True, fetcher=broken_fetch)
    assert not os.path.exists(partial)
    assert issubclass(download.DownloadRequired, RuntimeError)


def test_ensure_functions_with_a_fake_fetcher(tmp_path):
    fetched = []

    def fake_fetch(url, dest):
        fetched.append(url)
        with open(dest, "wb") as file:
            file.write(b"png")

    kodak_dir = str(tmp_path / "kodak")
    assert download.ensure_kodak_pngs(kodak_dir, True, fetcher=fake_fetch) == kodak_dir
    assert len(fetched) == 24 and fetched[0] == download.KODAK_SOURCE_URL + "kodim01.png"
    download.ensure_kodak_pngs(kodak_dir, False)  # all there: no fetch, no error
    with pytest.raises(download.DownloadRequired, match="ufldl.stanford.edu"):
        download.ensure_svhn_mats(str(tmp_path / "svhn"), allow_download=False)

    def fetch_archive(url, dest):
        assert url == download.BSDS_SOURCE_URL
        with tarfile.open(dest, "w:gz") as archive:
            for i in range(100):
                payload = b"jpeg-bytes-%03d" % i
                info = tarfile.TarInfo(f"BSDS300/images/test/{100000 + i}.jpg")
                info.size = len(payload)
                archive.addfile(info, io.BytesIO(payload))

    bsds_dir = str(tmp_path / "bsds")
    test_dir = download.ensure_bsds_images(bsds_dir, True, fetcher=fetch_archive)
    assert len(os.listdir(test_dir)) == 100

    def failing_fetch(url, dest):
        raise AssertionError("should not download again")

    assert download.ensure_bsds_images(bsds_dir, True, fetcher=failing_fetch) == test_dir


def test_untar_archive_refuses_a_member_outside_the_folder(tmp_path):
    path = str(tmp_path / "bad.tar")
    with tarfile.open(path, "w") as archive:
        info = tarfile.TarInfo("../escaped.txt")
        info.size = 1
        archive.addfile(info, io.BytesIO(b"x"))
    for module in (image, jax_image):
        with pytest.raises(ValueError, match="Unsafe tar member"):
            module.untar_archive(str(tmp_path / "out"), path)
    assert not (tmp_path / "escaped.txt").exists()


def test_create_datasets_cli(tmp_path, monkeypatch):
    source = _write_images(tmp_path / "images", [(40, 52, 3)] * 6, "png", seed=2)
    out = tmp_path / "out"
    create_datasets.main(["imagenet", "--source_dir", source, "--out_dir", str(out),
                          "--nb_training", "3", "--nb_validation", "2", "--width_crop", "32"])
    assert numpy.load(out / "imagenet" / "training_data.npy").shape == (3, 32, 32, 1)
    assert numpy.load(out / "imagenet" / "validation_data.npy").shape == (2, 32, 32, 1)
    # --download goes through the gated helpers (here a fake fetcher).
    shapes = iter([(512, 768, 3)] * 24)

    def fake_fetch(url, dest):
        rgb = numpy.full(next(shapes), 90, numpy.uint8)
        PIL.Image.fromarray(rgb).save(dest)

    monkeypatch.setattr(download, "_urlretrieve", fake_fetch)
    create_datasets.main(["kodak", "--source_dir", str(tmp_path / "kodak_src"), "--out_dir",
                          str(out), "--download"])
    assert numpy.load(out / "kodak" / "kodak.npy").shape == (24, 512, 768)
    # Without --download nothing is fetched: no image is found.
    with pytest.raises(RuntimeError, match="Expected 100 BSDS"):
        create_datasets.main(["bsds", "--source_dir", str(tmp_path / "none"), "--out_dir",
                              str(out)])
    # The SVHN creator runs, and says so when the folder holds no .mat file
    # (tests/test_torch_svhn_data.py builds the matrices from .mat files).
    with pytest.raises(RuntimeError, match="No SVHN .mat files"):
        create_datasets.main(["svhn", "--source_dir", source, "--out_dir", str(out),
                              "--nb_svhn_training", "10"])
    with pytest.raises(SystemExit):
        create_datasets.main(["cifar", "--source_dir", source])


@pytest.mark.parametrize("seed", [0, 1])
def test_image_utilities_equal_jax_on_random_inputs(seed, tmp_path):
    rng = numpy.random.default_rng(seed)
    luminance = rng.integers(0, 256, size=(120, 140)).astype(numpy.uint8)
    for is_random in (False, True):
        numpy.testing.assert_array_equal(
            image.crop_option_2d(luminance, 64, is_random, numpy.random.default_rng(seed)),
            jax_image.crop_option_2d(luminance, 64, is_random, numpy.random.default_rng(seed)))
    numpy.testing.assert_array_equal(image.crop_repeat_2d(luminance, 5, 9),
                                     jax_image.crop_repeat_2d(luminance, 5, 9))
    images = rng.integers(0, 256, size=(8, 6, 3, 5)).astype(numpy.uint8)
    rows = image.images_to_rows(images)
    numpy.testing.assert_array_equal(rows, jax_image.images_to_rows(images))
    numpy.testing.assert_array_equal(image.rows_to_images(rows, 8, 6), images)
    numpy.testing.assert_array_equal(jax_image.rows_to_images(rows, 8, 6), images)
    names = ["b.png", "a.jpg", "c.png", "notes.txt", "a.png"]
    for extension in (".png", (".png", ".jpg")):
        assert image.clean_sort_list_strings(names, extension) \
            == jax_image.clean_sort_list_strings(names, extension)
    rgb = rng.integers(0, 256, size=(9, 7, 3)).astype(numpy.uint8)
    numpy.testing.assert_array_equal(image.rgb_to_ycbcr(rgb), jax_image.rgb_to_ycbcr(rgb))
    path = str(tmp_path / "l.png")
    image.save_image(path, luminance)
    numpy.testing.assert_array_equal(image.read_image_mode(path, "L"), luminance)


def test_image_utilities_raise_like_jax(tmp_path):
    small = numpy.zeros((40, 40), numpy.uint8)
    path = str(tmp_path / "grey.png")
    PIL.Image.fromarray(small).save(path)
    for module in (image, jax_image):
        with pytest.raises(TypeError):
            module.crop_option_2d(small.astype(numpy.float32), 8, False)
        with pytest.raises(ValueError):
            module.crop_option_2d(small, 64, False)
        with pytest.raises(ValueError):
            module.crop_repeat_2d(small, 0, 0)
        with pytest.raises(TypeError):
            module.images_to_rows(numpy.zeros((4, 4, 3, 2), numpy.float32))
        with pytest.raises(ValueError):
            module.images_to_rows(numpy.zeros((4, 4, 1, 2), numpy.uint8))
        with pytest.raises(ValueError):
            module.rows_to_images(numpy.zeros((2, 47), numpy.uint8), 4, 4)
        with pytest.raises(ValueError, match="mode"):
            module.read_image_mode(path, "RGB")
