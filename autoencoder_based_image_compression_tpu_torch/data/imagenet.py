"""ImageNet training set, built from local files.

Reference ``kodak_tensorflow/datasets/imagenet/imagenet.py:8-113`` +
defaults in ``creating_imagenet.py:17-28``: 24000 training and 10
validation 256x256 BT.601 luminance crops from the ILSVRC2012
validation images (random crop for training, center crop for
validation), saved as monolithic uint8 ``.npy`` with a trailing
singleton channel.
"""

import glob
import os

import numpy

from autoencoder_based_image_compression_tpu_torch.utils.image import (
    crop_option_2d,
    luminance_bt601,
)


def create_imagenet_training(source_dir, path_to_training, path_to_validation,
                             nb_training=24000, nb_validation=10, width_crop=256,
                             seed=0):
    """Builds training/validation luminance crops from local JPEGs.

    Images smaller than the crop are skipped (the reference does the
    same). Idempotent via file existence.
    """
    import PIL.Image

    if os.path.isfile(path_to_training) and os.path.isfile(path_to_validation):
        print("The ImageNet crops already exist. Delete them manually to recompute them.")
        return
    paths = sorted(glob.glob(os.path.join(source_dir, "*.JPEG"))
                   + glob.glob(os.path.join(source_dir, "*.jpg"))
                   + glob.glob(os.path.join(source_dir, "*.png")))
    rng = numpy.random.default_rng(seed)
    training = numpy.zeros((nb_training, width_crop, width_crop, 1), dtype=numpy.uint8)
    validation = numpy.zeros((nb_validation, width_crop, width_crop, 1), dtype=numpy.uint8)
    count = 0
    for path in paths:
        if count >= nb_training + nb_validation:
            break
        image = PIL.Image.open(path)
        if image.mode != "RGB":
            continue
        rgb = numpy.asarray(image)
        if rgb.shape[0] < width_crop or rgb.shape[1] < width_crop:
            continue
        luminance = luminance_bt601(rgb)
        if count < nb_training:
            crop = crop_option_2d(luminance, width_crop, is_random=True, rng=rng)
            training[count, :, :, 0] = crop
        else:
            crop = crop_option_2d(luminance, width_crop, is_random=False)
            validation[count - nb_training, :, :, 0] = crop
        count += 1
    if count < nb_training + nb_validation:
        raise RuntimeError(
            f"Only {count} usable images in {source_dir}; "
            f"{nb_training + nb_validation} required.")
    os.makedirs(os.path.dirname(path_to_training) or ".", exist_ok=True)
    numpy.save(path_to_training, training)
    numpy.save(path_to_validation, validation)


def create_extra(source_dirs, path_to_extra, nb_extra=1000, width_crop=256, seed=1):
    """Held-out "extra" set for coding statistics.

    Reference ``datasets/extra/extra.py:9-145``: an ILSVRC2012 + INRIA
    Holidays mix; any local image folders work - what matters is that
    the set is disjoint from training and test so the coder statistics
    cost no bits at test time.
    """
    import PIL.Image

    if os.path.isfile(path_to_extra):
        print("The extra set already exists. Delete it manually to recompute it.")
        return
    paths = []
    for source_dir in source_dirs:
        for pattern in ("*.JPEG", "*.jpg", "*.png"):
            paths.extend(sorted(glob.glob(os.path.join(source_dir, pattern))))
    rng = numpy.random.default_rng(seed)
    extra = numpy.zeros((nb_extra, width_crop, width_crop, 1), dtype=numpy.uint8)
    count = 0
    for path in paths:
        if count >= nb_extra:
            break
        image = PIL.Image.open(path)
        if image.mode != "RGB":
            continue
        rgb = numpy.asarray(image)
        if rgb.shape[0] < width_crop or rgb.shape[1] < width_crop:
            continue
        extra[count, :, :, 0] = crop_option_2d(
            luminance_bt601(rgb), width_crop, is_random=True, rng=rng)
        count += 1
    if count < nb_extra:
        raise RuntimeError(f"Only {count} usable images; {nb_extra} required.")
    os.makedirs(os.path.dirname(path_to_extra) or ".", exist_ok=True)
    numpy.save(path_to_extra, extra)
