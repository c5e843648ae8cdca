"""Trains the conv entropy autoencoder on luminance crops.

Counterpart of ``kodak_tensorflow/training_eae_imagenet.py`` and of the
reference package's ``cli/train_eae.py``:
``python -m ...cli.train_eae <bin_width_init> <gamma> <idx_training>
[--learn_bin_widths] [--device cuda|cpu]``: multi-part resumable
training (part k resumes from the checkpoint of part k-1 and refuses to
overwrite part k), 80 epochs per part, batch 10, density pre-fit epochs
on the first part, the reference's per-epoch indicator block plus
dead-map counts, pdf areas and numeric-domain monitors (grid saturation,
negative per-map entropies); on the card, after each epoch's wall-clock
line, its device ms a step by phase (``train.loop.phase_line``).
Checkpoints are interchangeable with the reference package's.
"""

import argparse
import os
import time
import warnings

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    mark_checkpoint_complete,
    save_checkpoint,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import (
    device_resident_dataset,
    evaluate_full,
    phase_line,
    preliminary_fitting,
    run_epoch_training,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    current_lr,
    init_train_state,
)
from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
    int_strictly_positive,
)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Trains the conv entropy autoencoder.")
    parser.add_argument("bin_width_init", type=float_strictly_positive,
                        help="initial quantization bin width")
    parser.add_argument("gamma", type=float_strictly_positive,
                        help="entropy scaling coefficient")
    parser.add_argument("idx_training", type=int_positive,
                        help="training part index (0 for the first part)")
    parser.add_argument("--learn_bin_widths", action="store_true")
    parser.add_argument("--nb_epochs_training", type=int_strictly_positive, default=80)
    parser.add_argument("--nb_epochs_fitting", type=int_strictly_positive, default=1)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=10)
    parser.add_argument("--nb_eval_examples", type=int_strictly_positive, default=100,
                        help="evaluation-portion size for the epoch indicators "
                             "(clipped to the dataset sizes)")
    parser.add_argument("--path_to_training_data",
                        default="data/imagenet/training_data.npy")
    parser.add_argument("--path_to_validation_data",
                        default="data/imagenet/validation_data.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--seed", type=int_positive, default=0)
    parser.add_argument("--bw_warmup_steps", type=int_positive, default=0,
                        help="cold-start mitigation for --learn_bin_widths: "
                             "while step < this, the bin-width upper clip is "
                             "tightened to --bw_warmup_max so the rate "
                             "gradient rescales the transform instead of "
                             "inflating the quantizer; 0 disables")
    parser.add_argument("--bw_warmup_max", type=float_strictly_positive,
                        default=1.0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def _monitor_numeric_domain(indicators, nb_itvs):
    """Warns of the numeric-domain violations the reference asserts on:
    (a) a per-map approximate entropy went negative (the training loss
    clamps it, which zeroes its gradient; reference assertion
    ``tfutils.py:89-93``), (b) the fixed-capacity density table is full,
    so latents beyond it are clipped into the boundary cells."""
    per_map = indicators["approx_entropy_per_map"]
    if numpy.any(per_map < 0.0):
        bad = numpy.flatnonzero(per_map < 0.0)
        warnings.warn(
            f"{bad.size} per-map approximate entropies are negative "
            f"(maps {bad[:8].tolist()}{'...' if bad.size > 8 else ''}, "
            f"min {per_map.min():.4g}); the clamped training loss zeroes "
            "their gradients. The reference asserts on this "
            "(tfutils.py:89-93).", RuntimeWarning, stacklevel=2)
    if nb_itvs >= csts.MAX_ITVS_PER_SIDE:
        warnings.warn(
            f"The density grid saturated its static capacity "
            f"(nb_itvs_per_side == MAX_ITVS_PER_SIDE == "
            f"{csts.MAX_ITVS_PER_SIDE}); latents beyond the table are "
            "clipped into the boundary cells. Retrain with a larger "
            "max_itvs.", RuntimeWarning, stacklevel=2)


def _print_indicators(epoch, ind_t, ind_v, state, gamma):
    """The reference's per-epoch indicator block
    (``training_eae_imagenet.py:185-201``) and the monitors' lines."""
    nb_itvs = int(state.density.nb_itvs_per_side)
    step = int(state.step)
    print(f"\nEpoch: {epoch + 1}")
    print(f"Training mean approximate entropy: {ind_t['mean_approx_entropy']}")
    print(f"Validation mean approximate entropy: {ind_v['mean_approx_entropy']}")
    print(f"Training mean entropy: {ind_t['mean_disc_entropy']}")
    print(f"Validation mean entropy: {ind_v['mean_disc_entropy']}")
    print("Training scaled cumulated approximate entropy: "
          f"{ind_t['scaled_approx_entropy']}")
    print("Validation scaled cumulated approximate entropy: "
          f"{ind_v['scaled_approx_entropy']}")
    print(f"Training reconstruction error: {ind_t['rec_error']}")
    print(f"Validation reconstruction error: {ind_v['rec_error']}")
    print(f"Training loss of density approximation: {ind_t['loss_density']}")
    print(f"Validation loss of density approximation: {ind_v['loss_density']}")
    print("Training entropy minus approximate entropy: "
          f"{ind_t['entropy_gap']}")
    print("Validation entropy minus approximate entropy: "
          f"{ind_v['entropy_gap']}")
    print(f"L2-norm weight decay: {ind_t['weight_decay']}")
    print(f"Number of unit intervals in the right half of the grid: {nb_itvs}")
    print(f"Learning rate: {round(current_lr(gamma, step), 9)}")
    print(f"Global step: {step}")
    print(f"Dead feature maps (of {csts.NB_MAPS_3}): {ind_t['nb_dead_maps']}")
    areas = ind_t["areas_under_pdfs"]
    print(f"Area under the pdfs: mean={areas.mean():.4f} "
          f"min={areas.min():.4f} max={areas.max():.4f}")
    print("Mean quantization bin width: "
          f"{float(state.bin_widths.mean()):.4f}")
    _monitor_numeric_domain(ind_t, nb_itvs)


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    suffix = experiment_suffix(args.bin_width_init, args.gamma, args.learn_bin_widths)
    exp_dir = os.path.join(args.results_root, suffix)
    os.makedirs(exp_dir, exist_ok=True)

    training_uint8 = numpy.load(args.path_to_training_data)
    validation_uint8 = numpy.load(args.path_to_validation_data)
    nb_batches = training_uint8.shape[0] // args.batch_size

    # The initial parameters come from a CPU generator: one seed gives
    # one start on any device.
    state = init_train_state(torch.Generator().manual_seed(args.seed), args.bin_width_init,
                             args.learn_bin_widths, device=device)
    path_prev = os.path.join(exp_dir, f"model_{args.idx_training}")
    path_next = os.path.join(exp_dir, f"model_{args.idx_training + 1}")
    if checkpoint_exists(path_next):
        raise RuntimeError(f"{path_next} already exists; refusing to retrain part "
                           f"{args.idx_training}.")
    if args.idx_training > 0:
        state = load_checkpoint(path_prev, state)

    step_fns = make_step_fns(args.gamma, args.learn_bin_widths,
                             bw_warmup_steps=args.bw_warmup_steps,
                             bw_warmup_max=args.bw_warmup_max)
    seed_part = args.seed + 1000 * args.idx_training + 1
    noise = torch.Generator(device=device).manual_seed(seed_part)
    shuffle = numpy.random.default_rng(seed_part)

    t_start = time.time()
    # One upload: the loops gather mini-batches on the device.
    training_dev = device_resident_dataset(training_uint8, device)
    if args.idx_training == 0:
        state = preliminary_fitting(training_dev, state, step_fns, args.batch_size,
                                    args.nb_epochs_fitting, noise)
    nb_eval = min(args.nb_eval_examples, training_uint8.shape[0],
                  validation_uint8.shape[0])
    eval_train = training_dev[:nb_eval]
    eval_val = device_resident_dataset(validation_uint8[:nb_eval], device)
    history = {"train_disc_entropy": [], "train_rec_error": [], "val_rec_error": [],
               "train_entropy_gap": [], "val_entropy_gap": []}
    for epoch in range(args.nb_epochs_training):
        ind_t = evaluate_full(state, eval_train, step_fns, args.gamma, noise)
        ind_v = evaluate_full(state, eval_val, step_fns, args.gamma, noise)
        history["train_disc_entropy"].append(ind_t["mean_disc_entropy"])
        history["train_rec_error"].append(ind_t["rec_error"])
        history["val_rec_error"].append(ind_v["rec_error"])
        history["train_entropy_gap"].append(ind_t["entropy_gap"])
        history["val_entropy_gap"].append(ind_v["entropy_gap"])
        _print_indicators(epoch, ind_t, ind_v, state, args.gamma)
        t_epoch = time.time()
        state = run_epoch_training(training_dev, state, step_fns, args.batch_size,
                                   nb_batches, noise,
                                   permutation=shuffle.permutation(training_uint8.shape[0]))
        int(state.step)  # waits for the device: the epoch's work is done
        epoch_seconds = time.time() - t_epoch
        pixels = nb_batches * args.batch_size * numpy.prod(training_uint8.shape[1:3])
        print(f"Epoch wall-clock: {epoch_seconds:.2f} s "
              f"({nb_batches / epoch_seconds:.2f} steps/s, "
              f"{pixels / epoch_seconds / 1e6:.2f} Mpix/s)")
        line = phase_line(step_fns["train_epoch"])
        if line is not None:
            print(line)
        save_checkpoint(path_next, state, allow_overwrite=True)
    mark_checkpoint_complete(path_next)
    # Training-curve artifacts (reference training_eae_imagenet.py:259-326).
    if args.nb_epochs_training > 1:
        from autoencoder_based_image_compression_tpu_torch.eval.visualization import (
            plot_training_curves,
        )

        plot_training_curves(
            {"train rec error": history["train_rec_error"],
             "val rec error": history["val_rec_error"]},
            os.path.join(exp_dir, f"rec_error_part_{args.idx_training}.png"))
        plot_training_curves(
            {"mean discrete entropy": history["train_disc_entropy"]},
            os.path.join(exp_dir, f"entropy_part_{args.idx_training}.png"))
        plot_training_curves(
            {"train gap": history["train_entropy_gap"],
             "val gap": history["val_entropy_gap"]},
            os.path.join(exp_dir, f"entropy_gap_part_{args.idx_training}.png"))
    elapsed = time.time() - t_start
    print(f"training part {args.idx_training} done in "
          f"{int(elapsed // 3600)}h {int((elapsed % 3600) // 60)}m")


if __name__ == "__main__":
    main()
