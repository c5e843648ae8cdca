"""PyTorch port: the anchor codecs (``codecs/``) against the JAX
package's on the same images. They are host code (numpy, Pillow,
subprocess), so the two must agree exactly. HEVC runs through a stub
encoder that quantises the frame coarsely: the HM binary is a third-party
build that the repository does not carry.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import stat
import subprocess
import sys
import textwrap

import numpy
import pytest

from autoencoder_based_image_compression_tpu.codecs import hevc as jax_hevc
from autoencoder_based_image_compression_tpu.codecs import jpeg as jax_jpeg
from autoencoder_based_image_compression_tpu.codecs import jpeg2000 as jax_jpeg2000
from autoencoder_based_image_compression_tpu_torch import codecs
from autoencoder_based_image_compression_tpu_torch.codecs import common, hevc, jpeg, jpeg2000


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smooth_luminance(height, width, seed=0):
    rng = numpy.random.default_rng(seed)
    (yy, xx) = numpy.meshgrid(numpy.linspace(0, 1, height), numpy.linspace(0, 1, width),
                              indexing="ij")
    image = 100.0 + 80.0 * xx + 40.0 * yy + rng.normal(0, 3, (height, width))
    return numpy.round(image.clip(16, 235)).astype(numpy.uint8)


def test_evaluate_jpeg2000_pillow_equals_jax():
    images = numpy.stack([_smooth_luminance(64, 96, s) for s in range(2)])
    (rates, psnrs) = jpeg2000.evaluate_jpeg2000(images, ratios=(48, 12), backend="pillow")
    (rates_j, psnrs_j) = jax_jpeg2000.evaluate_jpeg2000(images, ratios=(48, 12),
                                                        backend="pillow")
    numpy.testing.assert_array_equal(rates, rates_j)
    numpy.testing.assert_array_equal(psnrs, psnrs_j)
    assert rates.shape == (2, 2) and numpy.all(rates[:, 1] > rates[:, 0])
    # A trailing channel axis is accepted, as the JAX package accepts it.
    (rates_4d, _) = jpeg2000.evaluate_jpeg2000(images[..., None], ratios=(48, 12),
                                               backend="pillow")
    numpy.testing.assert_array_equal(rates_4d, rates)
    assert jpeg2000.DEFAULT_RATIOS == jax_jpeg2000.DEFAULT_RATIOS
    assert jpeg2000.REFERENCE_QUALITIES == jax_jpeg2000.REFERENCE_QUALITIES


def test_compress_jpeg2000_equals_jax():
    image = _smooth_luminance(128, 128)
    (rate, reconstruction) = jpeg2000.compress_jpeg2000(image, 16)
    (rate_j, reconstruction_j) = jax_jpeg2000.compress_jpeg2000(image, 16)
    assert rate == rate_j > 0
    numpy.testing.assert_array_equal(reconstruction, reconstruction_j)


def test_imagemagick_backend_is_found_or_refused_like_jax(monkeypatch):
    assert jpeg2000.imagemagick_available() == jax_jpeg2000.imagemagick_available()
    monkeypatch.setenv("PATH", "")
    assert not jpeg2000.imagemagick_available()
    with pytest.raises(codecs.CodecUnavailableError, match="ImageMagick"):
        common.find_imagemagick()
    with pytest.raises(common.CodecUnavailableError):
        jpeg2000.evaluate_jpeg2000(_smooth_luminance(32, 32)[None], ratios=(30,),
                                   backend="imagemagick")
    assert issubclass(codecs.CodecUnavailableError, RuntimeError)


@pytest.mark.parametrize("codec,qualities", [("jpeg", [20, 80]), ("jpeg2000", [40, 10])])
def test_evaluate_jpeg_equals_jax(codec, qualities):
    rng = numpy.random.default_rng(2)
    rows = rng.integers(0, 256, size=(3, 3072)).astype(numpy.uint8)
    (rates, psnrs) = jpeg.evaluate_jpeg(rows, qualities, codec=codec)
    (rates_j, psnrs_j) = jax_jpeg.evaluate_jpeg(rows, qualities, codec=codec)
    numpy.testing.assert_array_equal(rates, rates_j)
    numpy.testing.assert_array_equal(psnrs, psnrs_j)
    assert rates.shape == (2,) and rates[1] > rates[0] and psnrs[1] > psnrs[0]


def test_compress_rgb_equals_jax_and_rejects_an_unknown_codec():
    rng = numpy.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(32, 32, 3)).astype(numpy.uint8)
    (rate, reconstruction) = jpeg.compress_rgb(rgb, 80, codec="jpeg")
    (rate_j, reconstruction_j) = jax_jpeg.compress_rgb(rgb, 80, codec="jpeg")
    assert rate == rate_j > 0
    numpy.testing.assert_array_equal(reconstruction, reconstruction_j)
    for module in (jpeg, jax_jpeg):
        with pytest.raises(ValueError):
            module.compress_rgb(rgb, 50, codec="webp")


def test_write_400_read_400_round_trip(tmp_path):
    image = _smooth_luminance(48, 80, 5)
    path = str(tmp_path / "frame.yuv")
    hevc.write_400(path, image)
    assert os.path.getsize(path) == image.size
    numpy.testing.assert_array_equal(hevc.read_400(path, 48, 80), image)
    numpy.testing.assert_array_equal(jax_hevc.read_400(path, 48, 80), image)
    assert hevc.INTRA_CFG == jax_hevc.INTRA_CFG


def _stub_encoder(tmp_path):
    """An executable with HM's command line: the reconstruction is the
    frame quantised with step QP / 2, the bitstream 6,000 / QP bytes."""
    path = tmp_path / "stub_encoder.py"
    path.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        import numpy
        args = sys.argv[1:]
        value = lambda flag: args[args.index(flag) + 1]
        qp = int([a for a in args if a.startswith("--QP=")][0][5:])
        assert "--InputChromaFormat=400" in args and "IntraPeriod: 1" in open(value("-c")).read()
        frame = numpy.fromfile(value("-i"), dtype=numpy.uint8)
        assert frame.size == int(value("-wdt")) * int(value("-hgt"))
        step = max(qp // 2, 1)
        (numpy.round(frame / step) * step).clip(0, 255).astype(numpy.uint8).tofile(value("-o"))
        open(value("-b"), "wb").write(bytes(6000 // qp))
        """))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_evaluate_hevc_through_a_stub_encoder_equals_jax(tmp_path):
    encoder = _stub_encoder(tmp_path)
    images = numpy.stack([_smooth_luminance(32, 48, s) for s in (7, 8)])
    (rates, psnrs) = hevc.evaluate_hevc(images, [22, 42], encoder)
    (rates_j, psnrs_j) = jax_hevc.evaluate_hevc(images, [22, 42], encoder)
    numpy.testing.assert_array_equal(rates, rates_j)
    numpy.testing.assert_array_equal(psnrs, psnrs_j)
    assert rates.shape == (2, 2)
    assert numpy.all(rates[:, 0] > rates[:, 1]) and numpy.all(psnrs[:, 0] > psnrs[:, 1])
    numpy.testing.assert_allclose(rates[:, 0], 8.0 * (6000 // 22) / (32 * 48))


def test_compress_hevc_refuses_a_missing_encoder(tmp_path):
    image = _smooth_luminance(32, 32)
    for path in ("", str(tmp_path / "absent")):
        with pytest.raises(codecs.CodecUnavailableError, match="HM encoder"):
            hevc.compress_hevc(image, 30, path, str(tmp_path))


def test_codec_modules_import_without_pil():
    """PIL is imported where an image is coded, not with the modules
    (checked in a fresh interpreter in which importing PIL raises)."""
    program = textwrap.dedent("""\
        import sys
        sys.modules["PIL"] = None
        import numpy
        from autoencoder_based_image_compression_tpu_torch.codecs import hevc, jpeg, jpeg2000
        from autoencoder_based_image_compression_tpu_torch.utils import image
        try:
            jpeg.compress_rgb(numpy.zeros((8, 8, 3), numpy.uint8), 50)
        except ImportError:
            print("coded nothing without PIL")
        """)
    done = subprocess.run([sys.executable, "-c", program], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "coded nothing without PIL" in done.stdout
