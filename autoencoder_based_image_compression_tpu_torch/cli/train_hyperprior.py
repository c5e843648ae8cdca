"""Trains Ballé et al.'s scale hyperprior (ICLR 2018, N = 128, M = 192)
or Minnen et al.'s joint autoregressive and hierarchical prior (NeurIPS
2018, N = M = 192) on RGB crops.

``python -m ...cli.train_hyperprior [--model hyperprior|minnen2018]
[--lmbda 0.01 | 0.013] [--path_to_training_data crops.npy | --nb_synthetic
1200] [--nb_epochs 1] [--batch_size 8] [--results_root
results/<model>] [--device cuda|cpu]``: ``--model`` names the model
(``train/hyperprior.py::MODELS``; the hyperprior by default), whose own
lambda is the default (0.01 and 0.013). The crops are
a uint8 ``(N, H, W, 3)`` ``.npy`` (H and W multiples of 64), or seeded
synthetic crops (three synthetic luminance images stacked as the
channels). Each epoch is ``train/loop.py::run_epoch_training`` over the
graphed step (the eager loop on the CPU), followed by the evaluation of
the first batch with the latents rounded (bpp from the exact discrete
likelihoods, MSE, PSNR), the epoch's wall clock and, on the card, its
device ms a step by phase; the state is saved after every epoch to
``<results_root>/lambda_<lmbda>/model`` (``train/checkpoint.py``) and
marked complete at the end; an existing one is not overwritten. No
bitstream is written: the model has no range coder yet.
"""

import argparse
import os
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    mark_checkpoint_complete,
    save_checkpoint,
)
from autoencoder_based_image_compression_tpu_torch.train.hyperprior import (
    MODELS,
    init_hyperprior_state,
    make_hyperprior_step_fns,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import (
    device_resident_dataset,
    phase_line,
    run_epoch_training,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import float_to_str
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
    int_strictly_positive,
)


def build_parser():
    parser = argparse.ArgumentParser(description="Trains the scale-hyperprior codec or "
                                                 "Minnen et al.'s joint prior codec.")
    parser.add_argument("--model", choices=sorted(MODELS), default="hyperprior")
    parser.add_argument("--lmbda", type=float_strictly_positive, default=None,
                        help="rate-distortion weight: loss = bpp + lmbda * 255^2 * mse "
                             "(default: the model's, 0.01 or 0.013)")
    parser.add_argument("--path_to_training_data", default=None,
                        help="uint8 (N, H, W, 3) .npy of crops; synthetic crops without it")
    parser.add_argument("--nb_synthetic", type=int_strictly_positive, default=1200)
    parser.add_argument("--crop", type=int_strictly_positive, default=256,
                        help="side of the synthetic crops")
    parser.add_argument("--nb_epochs", type=int_strictly_positive, default=1)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=8)
    parser.add_argument("--results_root", default=None,
                        help="where the checkpoint goes (default: results/<model>)")
    parser.add_argument("--seed", type=int_positive, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def synthetic_rgb(nb_images, side, seed):
    """``(nb_images, side, side, 3)`` uint8: three synthetic luminance
    stacks as the channels."""
    return numpy.concatenate([synthetic_luminance_stack(nb_images, side, side, seed + k)
                              for k in range(3)], axis=-1)


def load_crops(args):
    if args.path_to_training_data is None:
        return synthetic_rgb(args.nb_synthetic, args.crop, args.seed)
    crops = numpy.load(args.path_to_training_data)
    if crops.dtype != numpy.uint8 or crops.ndim != 4 or crops.shape[-1] != 3:
        raise ValueError(f"expected uint8 (N, H, W, 3) crops, got {crops.dtype} "
                         f"{crops.shape}.")
    if crops.shape[1] % 64 or crops.shape[2] % 64:
        raise ValueError(f"the crops' sides must be multiples of 64, got {crops.shape[1:3]}.")
    return crops


def main(args=None):
    args = build_parser().parse_args(args)
    (model, _, default_lmbda) = MODELS[args.model]
    lmbda = default_lmbda if args.lmbda is None else args.lmbda
    results_root = args.results_root or os.path.join("results", args.model)
    device = resolve_device(args.device)
    crops = load_crops(args)
    nb_batches = crops.shape[0] // args.batch_size
    if nb_batches == 0:
        raise ValueError(f"{crops.shape[0]} crops make no batch of {args.batch_size}.")
    path = os.path.join(results_root, f"lambda_{float_to_str(lmbda)}", "model")

    if checkpoint_exists(path):
        raise RuntimeError(f"{path}.npz already exists; refusing to overwrite a checkpoint.")
    state = init_hyperprior_state(torch.Generator().manual_seed(args.seed), device, model)
    step_fns = make_hyperprior_step_fns(lmbda, model)
    noise = torch.Generator(device=device).manual_seed(args.seed + 1)
    shuffle = numpy.random.default_rng(args.seed + 1)
    dataset = device_resident_dataset(crops, device)
    pixels = nb_batches * args.batch_size * crops.shape[1] * crops.shape[2]
    for epoch in range(args.nb_epochs):
        started = time.time()
        state = run_epoch_training(dataset, state, step_fns, args.batch_size, nb_batches,
                                   noise, permutation=shuffle.permutation(crops.shape[0]))
        step = int(state.step)  # waits for the device: the epoch's work is done
        seconds = time.time() - started
        print(f"Epoch {epoch}: step {step}, wall-clock {seconds:.2f} s "
              f"({nb_batches / seconds:.2f} steps/s, {pixels / seconds / 1e6:.2f} Mpix/s)")
        line = phase_line(step_fns["train_epoch"])
        if line is not None:
            print(line)
        scores = {name: float(value) for (name, value) in
                  step_fns["evaluation"](state, dataset[:args.batch_size]).items()}
        print("  rounded latents, first batch: " + ", ".join(
            f"{name} {scores[name]:.4f}" for name in ("bpp", "bpp_y", "bpp_z", "mse", "psnr",
                                                      "loss")))
        save_checkpoint(path, state, allow_overwrite=True)
    mark_checkpoint_complete(path)
    print(f"saved {path}.npz")
    return state


if __name__ == "__main__":
    main()
