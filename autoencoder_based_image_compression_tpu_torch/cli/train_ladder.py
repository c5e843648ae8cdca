"""Trains the WHOLE one-model-per-gamma RD ladder in one program.

Counterpart of running ``cli.train_eae`` once per gamma (the reference's
flagship study trains its 7 rate points as 7 separate
``training_eae_imagenet.py`` runs, ``reconstructing_eae_kodak.py:607-611``):
the stacked ladder state trains on shared mini-batches.

``python -m ...cli.train_ladder <bin_width_init> <idx_training>
[--gammas ...] [--device cuda|cpu]``: same multi-part resume scheme as
``train_eae`` (per-model checkpoints ``model_{k+1}`` in each experiment
directory, overwrite refusal, resume from part k-1), fixed-bin-width
architecture. Checkpoints are interchangeable with the reference
package's. On the card each epoch's wall-clock line is followed by its
device ms a ladder step by phase (``train.loop.phase_line``).
"""

import argparse
import os
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    mark_checkpoint_complete,
    save_checkpoint,
)
from autoencoder_based_image_compression_tpu_torch.train.ladder import (
    init_ladder_state,
    ladder_slice_state,
    ladder_stack_states,
    make_ladder_eval_fn,
    make_ladder_step_fns,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import (
    device_resident_dataset,
    phase_line,
    preliminary_fitting,
    run_epoch_training,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
    int_strictly_positive,
)

GAMMAS_DEFAULT = [10000.0, 12000.0, 16000.0, 24000.0, 40000.0, 72000.0, 96000.0]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Trains the whole gamma ladder simultaneously.")
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("idx_training", type=int_positive,
                        help="training part index (0 for the first part)")
    parser.add_argument("--gammas", type=float_strictly_positive, nargs="*",
                        default=None, help=f"ladder (default {GAMMAS_DEFAULT})")
    parser.add_argument("--nb_epochs_training", type=int_strictly_positive, default=80)
    parser.add_argument("--nb_epochs_fitting", type=int_strictly_positive, default=1)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=10)
    parser.add_argument("--nb_eval_examples", type=int_strictly_positive, default=100)
    parser.add_argument("--path_to_training_data",
                        default="data/imagenet/training_data.npy")
    parser.add_argument("--path_to_validation_data",
                        default="data/imagenet/validation_data.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--seed", type=int_positive, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    gammas = GAMMAS_DEFAULT if not args.gammas else args.gammas
    exp_dirs = [os.path.join(args.results_root,
                             experiment_suffix(args.bin_width_init, g, False))
                for g in gammas]
    paths_next = [os.path.join(d, f"model_{args.idx_training + 1}") for d in exp_dirs]
    for path in paths_next:
        if checkpoint_exists(path):
            raise RuntimeError(f"{path} already exists; refusing to retrain "
                               f"part {args.idx_training}.")

    training_uint8 = numpy.load(args.path_to_training_data)
    validation_uint8 = numpy.load(args.path_to_validation_data)
    nb_batches = training_uint8.shape[0] // args.batch_size

    # The initial parameters come from a CPU generator: one seed gives
    # one start on any device.
    if args.idx_training == 0:
        ladder = init_ladder_state(torch.Generator().manual_seed(args.seed), gammas,
                                   args.bin_width_init, device=device)
    else:
        template = init_train_state(torch.Generator().manual_seed(args.seed),
                                    args.bin_width_init, False, device=device)
        ladder = ladder_stack_states([
            load_checkpoint(os.path.join(exp_dir, f"model_{args.idx_training}"), template)
            for exp_dir in exp_dirs])

    fns = make_ladder_step_fns(gammas)
    eval_fn = make_ladder_eval_fn(gammas)
    seed_part = args.seed + 1000 * args.idx_training + 1
    noise = torch.Generator(device=device).manual_seed(seed_part)
    shuffle = numpy.random.default_rng(seed_part)

    t_start = time.time()
    training_dev = device_resident_dataset(training_uint8, device)
    if args.idx_training == 0:
        ladder = preliminary_fitting(training_dev, ladder, fns, args.batch_size,
                                     args.nb_epochs_fitting, noise)
    nb_eval = min(args.nb_eval_examples, training_uint8.shape[0],
                  validation_uint8.shape[0])
    eval_train = training_dev[:nb_eval]
    eval_val = device_resident_dataset(validation_uint8[:nb_eval], device)
    for epoch in range(args.nb_epochs_training):
        (rec_t, ent_t) = [x.cpu().numpy() for x in eval_fn(ladder, eval_train, noise)]
        (rec_v, ent_v) = [x.cpu().numpy() for x in eval_fn(ladder, eval_val, noise)]
        nb_itvs = ladder.density.nb_itvs_per_side.cpu().numpy()
        print(f"\nEpoch {epoch + 1} (global step {int(ladder.step[0])}):")
        for (k, gamma) in enumerate(gammas):
            print(f"  gamma={gamma:>8.0f}: approx-H {ent_t[k]:7.4f} "
                  f"(val {ent_v[k]:7.4f})  rec {rec_t[k]:9.2f} "
                  f"(val {rec_v[k]:9.2f})  grid {int(nb_itvs[k])}")
        t_epoch = time.time()
        ladder = run_epoch_training(training_dev, ladder, fns, args.batch_size, nb_batches,
                                    noise,
                                    permutation=shuffle.permutation(training_uint8.shape[0]))
        int(ladder.step[0])  # waits for the device: the epoch's work is done
        epoch_seconds = time.time() - t_epoch
        pixels = (nb_batches * args.batch_size
                  * int(numpy.prod(training_uint8.shape[1:3])))
        print(f"Epoch wall-clock: {epoch_seconds:.2f} s for {len(gammas)} "
              f"models ({nb_batches / epoch_seconds:.2f} ladder-steps/s, "
              f"{len(gammas) * pixels / epoch_seconds / 1e6:.2f} "
              "model-Mpix/s aggregate)")
        line = phase_line(fns["train_epoch"])
        if line is not None:
            print(line)
        for (k, (gamma, path)) in enumerate(zip(gammas, paths_next)):
            save_checkpoint(path, ladder_slice_state(ladder, k, gamma),
                            allow_overwrite=True)
    for path in paths_next:
        mark_checkpoint_complete(path)
    elapsed = time.time() - t_start
    print(f"ladder part {args.idx_training} ({len(gammas)} models) done in "
          f"{int(elapsed // 3600)}h {int((elapsed % 3600) // 60)}m")


if __name__ == "__main__":
    main()
