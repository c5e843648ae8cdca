"""The trained models and the images that the serving measurements run
on: the committed artifacts under ``results/eae/`` with their coding
statistics, and 24 Kodak-shaped luminance images."""

import os
import pickle

import numpy

from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_kodak,
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")


def load_model(exp_dir):
    """``(params, bin_widths, map_mean, probabilities, idx_exception)``
    of a trained experiment: the params artifact as CPU tensors in this
    package's layouts and the statistics at multiplier 1 beside it."""
    (params_np, bin_widths) = load_params_artifact(os.path.join(exp_dir, "params_trained.npz"))
    stats = os.path.join(exp_dir, "statistics")
    map_mean = numpy.load(os.path.join(stats, "map_mean.npy"))
    probabilities = numpy.load(os.path.join(stats, "binary_probabilities_1.npy"))
    with open(os.path.join(stats, "idx_map_exception.pkl"), "rb") as file:
        idx_exception = pickle.load(file)
    return (params_from_jax(params_np), bin_widths, map_mean, probabilities, idx_exception)


def kodak_images(smoke=False):
    """uint8 ``(24, 512, 768, 1)``: ``data/kodak/kodak.npy`` when the
    checkout has it, else ``synthetic_kodak(seed=0)`` (image-like
    content, so that fidelity is measured at a realistic operating
    point). ``smoke``: 4 synthetic images of 64 x 96."""
    if smoke:
        return synthetic_luminance_stack(4, 64, 96, seed=0)
    path = os.path.join(REPO, "data", "kodak", "kodak.npy")
    if os.path.isfile(path):
        images = numpy.load(path)
        if images.ndim == 3:
            images = images[..., None]
        return images.astype(numpy.uint8)
    return synthetic_kodak(seed=0)
