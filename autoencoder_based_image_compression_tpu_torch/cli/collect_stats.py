"""Collects coding statistics on the held-out "extra" set.

Counterpart of ``kodak_tensorflow/collecting_stats_eae_extra.py`` and of
the reference package's ``cli/collect_stats.py``: encodes the extra set
with a trained model (batch 20) and saves ``map_mean.npy``,
``idx_map_exception.pkl`` and per-multiplier
``binary_probabilities_<m>.npy`` (truncated-unary length 10). With them
a model trained by this package can be served by it.
"""

import argparse
import json
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.coding.stats import save_statistics
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_params_artifact,
    params_artifact_step,
    params_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import encode_mini_batches
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import (
    experiment_suffix,
    float_to_str,
)
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
    int_strictly_positive,
)

MULTIPLIERS = numpy.array([1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0],
                          dtype=numpy.float32)


def statistics_paths(stats_dir):
    """``[map_mean, idx_map_exception, binary_probabilities_<m>...]``."""
    return ([os.path.join(stats_dir, "map_mean.npy"),
             os.path.join(stats_dir, "idx_map_exception.pkl")]
            + [os.path.join(stats_dir, f"binary_probabilities_{float_to_str(float(m))}.npy")
               for m in MULTIPLIERS])


def main(args=None):
    parser = argparse.ArgumentParser(description="Collects coding statistics.")
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("gamma", type=float_strictly_positive)
    parser.add_argument("idx_training", type=int_positive)
    parser.add_argument("--learn_bin_widths", action="store_true")
    parser.add_argument("--batch_size", type=int_strictly_positive, default=20)
    parser.add_argument("--truncated_unary_length", type=int_strictly_positive,
                        default=10)
    parser.add_argument("--path_to_extra_data", default="data/extra/extra_data.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--from_params", action="store_true",
                        help="load the experiment's params_trained.npz export "
                             "instead of the model_{idx_training} train-state "
                             "checkpoint; also writes the stats_model_idx.json "
                             "pairing marker from the artifact's recorded step")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    suffix = experiment_suffix(args.bin_width_init, args.gamma, args.learn_bin_widths)
    exp_dir = os.path.join(args.results_root, suffix)
    stats_dir = os.path.join(exp_dir, "statistics")
    os.makedirs(stats_dir, exist_ok=True)

    artifact_step = None
    if args.from_params:
        path_artifact = os.path.join(exp_dir, "params_trained.npz")
        (params_np, bin_widths) = load_params_artifact(path_artifact)
        params = {name: value.to(device) for (name, value) in
                  params_from_jax(params_np).items()}
        artifact_step = params_artifact_step(path_artifact)
    else:
        template = init_train_state(torch.Generator().manual_seed(0), args.bin_width_init,
                                    args.learn_bin_widths, device=device)
        state = load_checkpoint(os.path.join(exp_dir, f"model_{args.idx_training}"), template)
        (params, bin_widths) = (state.params, state.bin_widths.cpu().numpy())
    extra_uint8 = numpy.load(args.path_to_extra_data)
    y_float32 = encode_mini_batches(extra_uint8, params, args.learn_bin_widths,
                                    args.batch_size)
    stats_paths = statistics_paths(stats_dir)
    # save_statistics leaves existing files alone, so the step-pairing
    # marker below is stamped only when this run wrote the tables: stale
    # probabilities must not be labelled with a new artifact's step.
    regenerating = not all(os.path.isfile(p) for p in stats_paths)
    save_statistics(y_float32, bin_widths, MULTIPLIERS, args.truncated_unary_length,
                    stats_paths[0], stats_paths[1], stats_paths[2:])
    if args.from_params:
        marker = os.path.join(stats_dir, "stats_model_idx.json")
        if regenerating:
            # The artifact carries only its training step, so the step
            # is the pairing key; a model index would be hearsay.
            with open(marker, "w") as file:
                json.dump({"step": artifact_step}, file)
        else:
            print(f"Statistics files pre-existed; {marker} left untouched "
                  "(delete the statistics to re-collect and re-stamp).")


if __name__ == "__main__":
    main()
