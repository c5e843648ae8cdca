"""Gated dataset acquisition (download + untar) for the dataset creators.

The reference automates downloads inside its dataset creators: Kodak
PNGs via ``urlretrieve`` (``datasets/kodak/kodak.py:85-108``), the BSDS
archive via ``download_untar_archive`` (``datasets/bsds/bsds.py:9-69``,
``tools/tools.py``), and the SVHN ``.mat`` files
(``svhn/svhn/svhn.py:76-168``). ILSVRC2012 archives are manual in the
reference too (``creating_imagenet.py:30``).

This module factors the same acquisition logic behind an explicit
opt-in: nothing touches the network unless ``allow_download=True``
(CLI ``--download``). Without it, a :class:`DownloadRequired` error
says exactly what to fetch and where to place it, so air-gapped
environments fail deterministically instead of hanging on egress.

The fetcher is injectable (``fetcher=`` argument) so tests exercise the
full ensure/untar logic without network access.
"""

import os

KODAK_SOURCE_URL = "http://r0k.us/graphics/kodak/kodak/"
BSDS_SOURCE_URL = ("https://www2.eecs.berkeley.edu/Research/Projects/CS/"
                   "vision/bsds/BSDS300-images.tgz")
SVHN_SOURCE_URL = "http://ufldl.stanford.edu/housenumbers/"
SVHN_MAT_NAMES = ("train_32x32.mat", "extra_32x32.mat")


class DownloadRequired(RuntimeError):
    """Raised when source files are missing and downloading is not enabled."""


def _urlretrieve(url, destination):
    import urllib.request

    urllib.request.urlretrieve(url, destination)


def download_file(url, destination, allow_download, fetcher=None):
    """Fetches ``url`` into ``destination`` unless it already exists.

    Returns True when a download happened, False when the file was
    already on disk. Raises :class:`DownloadRequired` when the file is
    missing and ``allow_download`` is False. A partial download is
    removed so a retry does not see a truncated file. ``fetcher``
    defaults to ``urllib`` at call time (resolved late so tests can
    monkeypatch ``_urlretrieve``).
    """
    if fetcher is None:
        fetcher = _urlretrieve
    if os.path.isfile(destination):
        return False
    if not allow_download:
        raise DownloadRequired(
            f"{destination} is missing. Re-run with --download to fetch it "
            f"from {url}, or place the file there manually.")
    os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
    try:
        fetcher(url, destination)
    except BaseException:
        if os.path.isfile(destination):
            os.remove(destination)
        raise
    return True


def ensure_kodak_pngs(source_dir, allow_download=False, fetcher=None):
    """Makes sure the 24 ``kodim*.png`` files are in ``source_dir``.

    Mirrors the reference's ``download_option``
    (``datasets/kodak/kodak.py:85-108``): per-image fetch, images
    already on disk are kept.
    """
    for i in range(24):
        name = "kodim" + str(i + 1).rjust(2, "0") + ".png"
        download_file(KODAK_SOURCE_URL + name, os.path.join(source_dir, name),
                      allow_download, fetcher)
    return source_dir


def ensure_bsds_images(source_dir, allow_download=False, fetcher=None):
    """Makes sure the BSDS300 test images are extracted under ``source_dir``.

    Downloads ``BSDS300-images.tgz`` (gated) and extracts it; returns
    the directory holding the 100 test JPEGs
    (``BSDS300/images/test``). Mirrors ``datasets/bsds/bsds.py:53-69``.
    """
    test_dir = os.path.join(source_dir, "BSDS300", "images", "test")
    if os.path.isdir(test_dir) and len(os.listdir(test_dir)) == 100:
        return test_dir
    archive = os.path.join(source_dir, "BSDS300-images.tgz")
    download_file(BSDS_SOURCE_URL, archive, allow_download, fetcher)
    from autoencoder_based_image_compression_tpu_torch.utils.image import untar_archive

    untar_archive(source_dir, archive)
    return test_dir


def ensure_svhn_mats(source_dir, allow_download=False, fetcher=None):
    """Makes sure the SVHN ``.mat`` files are in ``source_dir``.

    Fetches ``train_32x32.mat`` and ``extra_32x32.mat`` (the two the
    creator consumes; reference ``svhn/svhn/svhn.py:76-168`` also pulls
    ``test_32x32.mat``, whose digits end up in the same shuffled pool).
    """
    for name in SVHN_MAT_NAMES:
        download_file(SVHN_SOURCE_URL + name, os.path.join(source_dir, name),
                      allow_download, fetcher)
    return source_dir
