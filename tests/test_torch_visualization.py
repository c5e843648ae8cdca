"""PyTorch port: every figure of ``eval/visualization.py`` writes a
non-empty file, and the ones written with PIL (mosaics, crops, the
dead-latent map) hold the same pixels as the JAX package's, bit for bit.
The matplotlib figures are drawn from the same arrays by the same calls;
their bytes depend on the renderer, so only their existence is held."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import numpy
import PIL.Image
import pytest

from autoencoder_based_image_compression_tpu.eval import visualization as jax_viz
from autoencoder_based_image_compression_tpu_torch.eval import visualization as viz
from autoencoder_based_image_compression_tpu_torch.ops import density as dens

RNG = numpy.random.default_rng(2)
GRID = dens.table_grid(4, 8)
PDFS = numpy.tile(1.0 / (numpy.pi * (1.0 + GRID ** 2)), (3, 1))
LUMINANCES = RNG.integers(0, 256, size=(5, 12, 10, 1)).astype(numpy.uint8)
IMAGE = RNG.integers(0, 256, size=(200, 180)).astype(numpy.uint8)
POSITIONS = numpy.array([[10, 50], [20, 90]])
RGB = RNG.integers(0, 256, size=(8, 9, 3, 7)).astype(numpy.uint8)
ROWS = RNG.integers(0, 256, size=(5, 3 * 8 * 6)).astype(numpy.uint8)

# name -> (call writing under a directory, the files it writes).
FIGURES = {
    "normed_histogram": (lambda m, d: m.normed_histogram(
        RNG.normal(size=(2, 8, 8, 3)).astype(numpy.float32), GRID, PDFS,
        [f"map {i}" for i in range(3)], [os.path.join(d, f"hist_{i}.png") for i in range(3)]),
        ["hist_0.png", "hist_1.png", "hist_2.png"]),
    "visualize_weights": (lambda m, d: m.visualize_weights(
        RNG.normal(size=(9, 9, 1, 8)).astype(numpy.float32), 4, os.path.join(d, "w.png")),
        ["w.png"]),
    "visualize_representation": (lambda m, d: m.visualize_representation(
        RNG.normal(size=(4, 6, 8)).astype(numpy.float32), 4, os.path.join(d, "l.png")),
        ["l.png"]),
    "plot_nb_dead_feature_maps": (lambda m, d: m.plot_nb_dead_feature_maps(
        [0.1, 0.2, 0.4], [30, 12, 3], os.path.join(d, "deads.png")), ["deads.png"]),
    "plot_training_curves": (lambda m, d: m.plot_training_curves(
        {"rec": [3.0, 2.0, 1.5]}, os.path.join(d, "curves.png")), ["curves.png"]),
    "histogram": (lambda m, d: m.histogram(RNG.normal(size=500), "h",
                                           os.path.join(d, "h.png")), ["h.png"]),
    "visualize_luminances": (lambda m, d: m.visualize_luminances(
        LUMINANCES, 2, os.path.join(d, "lum.png")), ["lum.png"]),
    "visualize_crops": (lambda m, d: m.visualize_crops(
        IMAGE, POSITIONS, [os.path.join(d, "c0.png"), os.path.join(d, "c1.png")]),
        ["c0.png", "c1.png"]),
    "visualize_rotated_luminance": (lambda m, d: m.visualize_rotated_luminance(
        IMAGE, True, POSITIONS, [os.path.join(d, n) for n in ("r.png", "r0.png", "r1.png")]),
        ["r.png", "r0.png", "r1.png"]),
    "visualize_dead": (lambda m, d: m.visualize_dead(
        numpy.round(RNG.normal(size=(6, 11))), os.path.join(d, "dead.png")), ["dead.png"]),
    "visualize_images": (lambda m, d: m.visualize_images(RGB, 3, os.path.join(d, "rgb.png")),
                         ["rgb.png"]),
    "visualize_rows": (lambda m, d: m.visualize_rows(ROWS, 8, 6, 2, os.path.join(d, "rows.png")),
                       ["rows.png"]),
    "visualize_dense_weights": (lambda m, d: m.visualize_dense_weights(
        RNG.normal(size=(5, 3 * 8 * 6)), 8, 6, 2, os.path.join(d, "dense.png")),
        ["dense.png"]),
}
PIL_WRITTEN = {"visualize_luminances", "visualize_crops", "visualize_rotated_luminance",
               "visualize_dead", "visualize_images", "visualize_rows", "visualize_dense_weights"}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_writes_its_files(name, tmp_path):
    (draw, files) = FIGURES[name]
    draw(viz, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(files)
    for file in files:
        assert os.path.getsize(tmp_path / file) > 0


@pytest.mark.parametrize("name", sorted(PIL_WRITTEN))
def test_pil_figure_equals_jax(name, tmp_path):
    (draw, files) = FIGURES[name]
    for (module, folder) in ((viz, "port"), (jax_viz, "jax")):
        (tmp_path / folder).mkdir()
        # The same random inputs for both: the draws are made inside the
        # lambdas, so fix the generator's state around each call.
        state = RNG.bit_generator.state
        draw(module, str(tmp_path / folder))
        RNG.bit_generator.state = state
    for file in files:
        (got, expected) = (numpy.asarray(PIL.Image.open(tmp_path / folder / file))
                           for folder in ("port", "jax"))
        assert got.dtype == numpy.uint8
        numpy.testing.assert_array_equal(got, expected)


def test_mosaic_checks_match_jax():
    with pytest.raises(TypeError):
        viz.visualize_luminances(LUMINANCES.astype(numpy.float32), 2, "x.png")
    with pytest.raises(ValueError):
        viz.visualize_images(RGB[:, :, :2], 2, "x.png")
    with pytest.raises(ValueError):
        viz.visualize_crops(IMAGE, POSITIONS, ["only_one.png"])
