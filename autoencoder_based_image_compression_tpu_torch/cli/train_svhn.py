"""Trains the dense entropy autoencoder on SVHN digits.

Counterpart of ``svhn/training_eae_svhn.py`` and of the reference
package's ``cli/train_svhn.py``: ``python -m ...cli.train_svhn
<bin_width_init> <gamma> [--learn_bin_width] [--synthetic] [--device
cuda|cpu]``. 800 epochs, batch 250, per-pixel-mean / global-std
preprocessing, density pre-fit before the first epoch; the state goes
through the npz checkpointer under the reference's keys, so either
package's ``reconstruct_svhn`` loads it.

The training set is uploaded once and every batch is gathered on the
device. One ``eps`` is drawn per batch and both phases of the batch see
it, as both of the reference's phases see one key. The pre-fit epochs
and the training epochs are the step functions' ``fit_epoch`` and
``train_epoch``: on the card the replays of one captured step each (the
JAX command line's jitted steps), on the CPU the eager loop. The
permutation of an epoch is drawn on the host, one an epoch.
"""

import argparse
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.data.svhn import (
    compute_preprocessing_stats,
    preprocess_svhn,
    synthetic_svhn,
)
from autoencoder_based_image_compression_tpu_torch.models import dense_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import save_checkpoint
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import rows_in_order
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
    int_strictly_positive,
)


def main(args=None):
    parser = argparse.ArgumentParser(description="Trains the SVHN dense EAE.")
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("gamma", type=float_strictly_positive)
    parser.add_argument("--learn_bin_width", action="store_true")
    parser.add_argument("--nb_epochs_training", type=int_strictly_positive, default=800)
    parser.add_argument("--nb_epochs_fitting", type=int_strictly_positive, default=1)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=250)
    parser.add_argument("--path_to_training_data", default="data/svhn/training_data.npy")
    parser.add_argument("--results_root", default="results/svhn")
    parser.add_argument("--seed", type=int_positive, default=0)
    parser.add_argument("--synthetic", action="store_true",
                        help="use synthetic digits (development only)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    if args.synthetic or not os.path.isfile(args.path_to_training_data):
        training_uint8 = synthetic_svhn(2000, seed=args.seed)
        print("using synthetic SVHN digits")
    else:
        training_uint8 = numpy.load(args.path_to_training_data)
    (mean_training, std_training) = compute_preprocessing_stats(training_uint8)
    training = torch.from_numpy(
        preprocess_svhn(training_uint8, mean_training, std_training)).to(device)

    exp_dir = os.path.join(args.results_root,
                           experiment_suffix(args.bin_width_init, args.gamma,
                                             args.learn_bin_width))
    os.makedirs(exp_dir, exist_ok=True)
    numpy.savez(os.path.join(exp_dir, "preprocessing.npz"),
                mean_training=mean_training, std_training=std_training)

    state = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(args.seed),
                                           args.bin_width_init, device=device)
    fns = dense_eae.make_dense_step_fns(args.gamma, args.learn_bin_width)
    noise = torch.Generator(device).manual_seed(args.seed + 1)
    nb_batches = training.shape[0] // args.batch_size
    rng = numpy.random.default_rng(args.seed)

    for _ in range(args.nb_epochs_fitting):
        state = fns["fit_epoch"](state, training, rows_in_order(nb_batches, args.batch_size),
                                 noise)
    for epoch in range(args.nb_epochs_training):
        permutation = rng.permutation(training.shape[0])
        rows = permutation[:nb_batches * args.batch_size].reshape(nb_batches, args.batch_size)
        state = fns["train_epoch"](state, training, rows, noise)
        if epoch % 50 == 0 or epoch == args.nb_epochs_training - 1:
            (approx_h, _, rec, fct, _) = fns["evaluation"](
                state, training[:args.batch_size], noise)
            print(f"epoch {epoch}: approx-H {float(approx_h):.3f} "
                  f"rec {float(rec):.2f} fct-loss {float(fct):.4f} "
                  f"bw {float(state.bin_width):.3f}")
    save_checkpoint(os.path.join(exp_dir, "model"), state, allow_overwrite=True)
    print(f"model saved under {exp_dir}")
    return state


if __name__ == "__main__":
    main()
