"""BSDS test set, built from local files.

Reference ``kodak_tensorflow/datasets/bsds/bsds.py:9-108``: the 100
BSDS300 test images (481x321) -> BT.601 luminance, rotated to landscape
when portrait, cropped to 320x480; artifacts ``bsds.npy``
(100, 320, 480) uint8 + ``list_rotation.pkl``.
"""

import glob
import os
import pickle

import numpy

from autoencoder_based_image_compression_tpu_torch.utils.image import (
    luminance_bt601,
    read_image_mode,
)

BSDS_HEIGHT = 320
BSDS_WIDTH = 480


def create_bsds(source_dir, path_to_bsds, path_to_list_rotation):
    """Builds ``bsds.npy`` + ``list_rotation.pkl`` from BSDS300 test JPEGs."""
    if os.path.isfile(path_to_bsds) and os.path.isfile(path_to_list_rotation):
        print("The BSDS dataset already exists. Delete it manually to recompute it.")
        return
    paths = sorted(glob.glob(os.path.join(source_dir, "*.jpg")))
    if len(paths) != 100:
        raise RuntimeError(
            f"Expected 100 BSDS test images in {source_dir}, found {len(paths)}.")
    stack = numpy.zeros((100, BSDS_HEIGHT, BSDS_WIDTH), dtype=numpy.uint8)
    list_rotation = []
    for (i, path) in enumerate(paths):
        rgb = read_image_mode(path, "RGB")
        luminance = luminance_bt601(rgb)
        if luminance.shape[0] > luminance.shape[1]:
            luminance = numpy.rot90(luminance)
            list_rotation.append(i)
        stack[i] = luminance[:BSDS_HEIGHT, :BSDS_WIDTH]
    os.makedirs(os.path.dirname(path_to_bsds) or ".", exist_ok=True)
    numpy.save(path_to_bsds, stack)
    with open(path_to_list_rotation, "wb") as file:
        pickle.dump(list_rotation, file)
