"""Kodak test set, built from local files.

Reference ``kodak_tensorflow/datasets/kodak/kodak.py:10-109``: 24 PNGs
-> BT.601 luminance, portrait images rotated to landscape with the
rotated indices recorded (``list_rotation.pkl``), stacked into a
(24, 512, 768) uint8 ``.npy``.
"""

import glob
import os
import pickle

import numpy

from autoencoder_based_image_compression_tpu_torch.utils.image import (
    luminance_bt601,
    read_image_mode,
)

KODAK_HEIGHT = 512
KODAK_WIDTH = 768


def create_kodak(source_dir, path_to_kodak, path_to_list_rotation):
    """Builds ``kodak.npy`` + ``list_rotation.pkl`` from downloaded PNGs.

    ``source_dir`` holds the 24 ``kodim*.png`` files (the reference
    downloads them from r0k.us; this function consumes a local copy).
    Idempotent: existing artifacts are kept.
    """
    if os.path.isfile(path_to_kodak) and os.path.isfile(path_to_list_rotation):
        print("The Kodak dataset already exists. Delete it manually to recompute it.")
        return
    paths = sorted(glob.glob(os.path.join(source_dir, "*.png")))
    if len(paths) != 24:
        raise RuntimeError(
            f"Expected 24 Kodak PNGs in {source_dir}, found {len(paths)}.")
    stack = numpy.zeros((24, KODAK_HEIGHT, KODAK_WIDTH), dtype=numpy.uint8)
    list_rotation = []
    for (i, path) in enumerate(paths):
        rgb = read_image_mode(path, "RGB")
        luminance = luminance_bt601(rgb)
        if luminance.shape == (KODAK_WIDTH, KODAK_HEIGHT):
            luminance = numpy.rot90(luminance)
            list_rotation.append(i)
        elif luminance.shape != (KODAK_HEIGHT, KODAK_WIDTH):
            raise ValueError(f"{path} has unexpected shape {luminance.shape}.")
        stack[i] = luminance
    os.makedirs(os.path.dirname(path_to_kodak) or ".", exist_ok=True)
    numpy.save(path_to_kodak, stack)
    with open(path_to_list_rotation, "wb") as file:
        pickle.dump(list_rotation, file)
