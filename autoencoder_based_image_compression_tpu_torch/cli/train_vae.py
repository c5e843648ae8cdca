"""Trains, reconstructs with and samples the SVHN variational autoencoder.

Counterpart of ``svhn/training_vae_svhn.py``,
``reconstructing_vae_svhn.py`` and ``generating_vae_svhn.py`` and of the
reference package's ``cli/train_vae.py``: one entry point with the
subcommands ``train``, ``reconstruct`` and ``generate``, plus ``--device
cuda|cpu``. ``train`` runs its epochs through ``vae.make_vae_epoch_fn``
(on the card, the replays of one captured step) and writes ``model.npz``
and its ``model.json`` sidecar (no density: ``nb_itvs_per_side`` is
null), which ``reconstruct`` and ``generate`` load, and so does the
reference package's loader.
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
from autoencoder_based_image_compression_tpu_torch.models import vae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_strictly_positive,
)


def _to_uint8(rows, stats):
    """Undoes the preprocessing of float32 rows on the host."""
    rows = rows.cpu().numpy() * float(stats["std_training"]) + stats["mean_training"]
    return numpy.round(rows.clip(0, 255)).astype(numpy.uint8)


def main(args=None):
    parser = argparse.ArgumentParser(description="SVHN VAE.")
    parser.add_argument("command", choices=["train", "reconstruct", "generate"])
    parser.add_argument("--alpha", type=float_strictly_positive, default=1.0)
    parser.add_argument("--nb_hidden", type=int_strictly_positive, default=300)
    parser.add_argument("--nb_z", type=int_strictly_positive, default=25)
    parser.add_argument("--nb_epochs_training", type=int_strictly_positive, default=200)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=250)
    parser.add_argument("--path_to_training_data", default="data/svhn/training_data.npy")
    parser.add_argument("--results_root", default="results/vae")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    os.makedirs(args.results_root, exist_ok=True)
    path_model = os.path.join(args.results_root, "model")
    template = vae.init_vae_state(torch.Generator().manual_seed(0), nb_hidden=args.nb_hidden,
                                  nb_z=args.nb_z, device=device)

    if args.command == "train":
        if os.path.isfile(args.path_to_training_data):
            training_uint8 = numpy.load(args.path_to_training_data)
        else:
            training_uint8 = synthetic_svhn(2000)
            print("using synthetic SVHN digits")
        (mean_training, std_training) = compute_preprocessing_stats(training_uint8)
        numpy.savez(os.path.join(args.results_root, "preprocessing.npz"),
                    mean_training=mean_training, std_training=std_training)
        training = torch.from_numpy(
            preprocess_svhn(training_uint8, mean_training, std_training)).to(device)
        state = template
        train_epoch = vae.make_vae_epoch_fn(args.alpha)
        noise = torch.Generator(device).manual_seed(1)
        nb_batches = training.shape[0] // args.batch_size
        rng = numpy.random.default_rng(0)
        losses = []
        for epoch in range(args.nb_epochs_training):
            permutation = rng.permutation(training.shape[0])
            rows = permutation[:nb_batches * args.batch_size].reshape(nb_batches,
                                                                      args.batch_size)
            state = train_epoch(state, training, rows, noise)
            if epoch % 20 == 0 or epoch == args.nb_epochs_training - 1:
                with torch.no_grad():
                    losses.append(float(vae.opposite_vlb(
                        state.params, training[:args.batch_size], noise, args.alpha)))
                print(f"epoch {epoch}: -VLB {losses[-1]:.2f}")
        save_checkpoint(path_model, state, allow_overwrite=True)
        print(f"model saved under {args.results_root}")
        return losses
    stats = numpy.load(os.path.join(args.results_root, "preprocessing.npz"))
    state = load_checkpoint(path_model, template)
    if args.command == "reconstruct":
        digits_uint8 = (numpy.load(args.path_to_training_data)[:8]
                        if os.path.isfile(args.path_to_training_data)
                        else synthetic_svhn(8))
        digits = preprocess_svhn(digits_uint8, stats["mean_training"],
                                 float(stats["std_training"]))
        with torch.no_grad():
            (_, _, _, rec) = vae.forward_pass(state.params, digits,
                                              torch.Generator(device).manual_seed(2))
        rec_uint8 = _to_uint8(rec, stats)
        numpy.save(os.path.join(args.results_root, "reconstructions.npy"), rec_uint8)
        print("reconstructions saved")
        return rec_uint8
    samples = vae.generate(state.params, torch.Generator(device).manual_seed(3), 16,
                           nb_z=args.nb_z)
    digits_uint8 = _to_uint8(samples, stats)
    numpy.save(os.path.join(args.results_root, "generated.npy"), digits_uint8)
    print("samples saved")
    return digits_uint8


if __name__ == "__main__":
    main()
