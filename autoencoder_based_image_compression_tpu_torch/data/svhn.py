"""SVHN dataset builder and preprocessing (numpy and scipy only; the same
functions as the reference package's ``data/svhn.py``).

Reference ``svhn/svhn/svhn.py:13-273`` + ``creating_svhn.py:13-25``:
the ``.mat`` files (train 73257 + extra 531131 digits) are shuffled and
split into 200000 training / 1000 validation / 1000 test rows of
flattened 32x32x3 uint8; preprocessing is per-pixel mean subtraction
plus division by the global standard deviation (computed on the
training set only).
"""

import os

import numpy


def _load_mat_rows(path):
    import scipy.io

    mat = scipy.io.loadmat(path)
    x = mat["X"]  # (32, 32, 3, N)
    # Flatten to rows (N, 3072) in H, W, C order like the reference's
    # row layout (svhn/svhn/svhn.py:74-168).
    return numpy.transpose(x, (3, 0, 1, 2)).reshape(x.shape[3], -1)


def create_svhn(source_dir, path_to_training, path_to_validation, path_to_test,
                nb_training=200000, nb_validation=1000, nb_test=1000, seed=0):
    """Builds the shuffled train/validation/test row matrices."""
    done = all(os.path.isfile(p) for p in
               (path_to_training, path_to_validation, path_to_test))
    if done:
        print("The SVHN dataset already exists. Delete it manually to recompute it.")
        return
    rows = [_load_mat_rows(os.path.join(source_dir, name))
            for name in ("train_32x32.mat", "extra_32x32.mat")
            if os.path.isfile(os.path.join(source_dir, name))]
    if not rows:
        raise RuntimeError(f"No SVHN .mat files found in {source_dir}.")
    all_rows = numpy.concatenate(rows, axis=0)
    needed = nb_training + nb_validation + nb_test
    if all_rows.shape[0] < needed:
        raise RuntimeError(f"Only {all_rows.shape[0]} digits; {needed} required.")
    rng = numpy.random.default_rng(seed)
    permutation = rng.permutation(all_rows.shape[0])
    shuffled = all_rows[permutation[:needed]].astype(numpy.uint8)
    os.makedirs(os.path.dirname(path_to_training) or ".", exist_ok=True)
    numpy.save(path_to_training, shuffled[:nb_training])
    numpy.save(path_to_validation, shuffled[nb_training:nb_training + nb_validation])
    numpy.save(path_to_test, shuffled[nb_training + nb_validation:needed])


def compute_preprocessing_stats(training_uint8, chunk=10000):
    """(per-pixel mean, global std) from the training rows in chunks.

    Reference ``svhn/svhn/svhn.py:170-273`` computes both in chunks to
    bound memory; chunking kept for very large training matrices.
    """
    nb = training_uint8.shape[0]
    mean_acc = numpy.zeros(training_uint8.shape[1], dtype=numpy.float64)
    for i in range(0, nb, chunk):
        mean_acc += numpy.sum(training_uint8[i:i + chunk].astype(numpy.float64), axis=0)
    mean = mean_acc / nb
    var_acc = 0.0
    for i in range(0, nb, chunk):
        centered = training_uint8[i:i + chunk].astype(numpy.float64) - mean
        var_acc += numpy.sum(centered ** 2)
    std = numpy.sqrt(var_acc / (nb * training_uint8.shape[1]))
    return (mean.astype(numpy.float32), numpy.float32(std))


def preprocess_svhn(rows_uint8, mean_training, std_training):
    """Centers per pixel and reduces by the global std."""
    return ((rows_uint8.astype(numpy.float32) - mean_training) / std_training)


def synthetic_svhn(nb_digits, seed=0):
    """Synthetic stand-in rows (N, 3072) uint8 for development."""
    rng = numpy.random.default_rng(seed)
    smooth = rng.integers(40, 216, size=(nb_digits, 1, 1, 3))
    noise = rng.normal(0.0, 25.0, size=(nb_digits, 32, 32, 3))
    digits = (smooth + noise).clip(0, 255).astype(numpy.uint8)
    return digits.reshape(nb_digits, -1)
