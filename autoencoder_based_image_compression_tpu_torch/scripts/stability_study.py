"""Checkpoint-averaging stability protocol for the per-gamma family, on
the card unless ``--device cpu`` is given.

The one-model-per-gamma family's Bjontegaard summary is fragile at short
training budgets: single gamma models move from part to part and the
cubic fit amplifies it. The reference's number rests on seven converged
models (``reconstructing_eae_kodak.py:607-611,837-856``); until then,
this script is the explicit stability protocol:

1. for every gamma, average the parameters of the last K complete part
   checkpoints (:func:`average_gamma_params`; tail averaging as in SWA:
   the bin widths are fixed at 1.0 for this family, and the per-gamma
   rate of the study is the empirical entropy of the quantised latents,
   so averaged parameters are self-contained),
2. export the averaged models as ``params_trained.npz`` under a separate
   results root (:func:`export_averages`),
3. run the same RD study, with the main study's anchor caches, on the
   averaged models (:func:`copy_anchor_caches`, :func:`evaluate`),
4. write a side-by-side comparison of the last-checkpoint and averaged
   Bjontegaard summaries (:func:`write_comparison`), so that the
   committed headline documents its own checkpoint sensitivity.

Usage::

    python -m autoencoder_based_image_compression_tpu_torch.scripts.stability_study --k 3 \\
        [--results_root results/eae] [--study_dir results/eae/kodak_rd] [--device cuda]
"""

import argparse
import glob
import json
import os
import pickle
import re
import shutil

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.cli import reconstruct_kodak
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_part_complete,
    load_checkpoint,
    params_from_jax,
    params_to_jax,
    save_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

GAMMAS = [10000.0, 12000.0, 16000.0, 24000.0, 40000.0, 72000.0, 96000.0]


def _complete_part_indices(exp_dir):
    """Sorted indices ``n`` of the ``model_<n>`` checkpoints whose part
    ran to completion."""
    indices = []
    for path in glob.glob(os.path.join(exp_dir, "model_*.npz")):
        match = re.fullmatch(r"model_(\d+)\.npz", os.path.basename(path))
        if match and checkpoint_part_complete(path[:-len(".npz")]):
            indices.append(int(match.group(1)))
    return sorted(indices)


def average_gamma_params(exp_dir, gamma, k, device="cuda"):
    """Mean of the params over the last ``k`` complete part checkpoints,
    summed in float64 and cast to float32 after the division, in the
    reference's layouts (numpy, as ``save_params_artifact`` and the
    reference package's loader take them). ``gamma`` names the model
    only; the checkpoints carry its state.

    Returns ``(params_mean, bin_widths, last_step, used_indices)``: the
    bin widths and step of the last part used.
    """
    del gamma  # the template is the same for every fixed-bin-width model
    indices = _complete_part_indices(exp_dir)[-k:]
    if not indices:
        raise FileNotFoundError(f"no complete checkpoints under {exp_dir}")
    template = init_train_state(torch.Generator().manual_seed(0), 1.0, False, device=device)
    total = None
    last = None
    for idx in indices:
        state = load_checkpoint(os.path.join(exp_dir, f"model_{idx}"), template)
        params = {name: value.astype(numpy.float64)
                  for (name, value) in params_to_jax(state.params).items()}
        total = (params if total is None else
                 {name: total[name] + params[name] for name in params})
        last = state
    mean = {name: (value / len(indices)).astype(numpy.float32)
            for (name, value) in total.items()}
    return (mean, last.bin_widths.cpu().numpy(), int(last.step), indices)


def export_averages(results_root, avg_root, k, device="cuda"):
    """Averages each gamma's last ``k`` parts and exports the mean as
    ``<avg_root>/<suffix>/params_trained.npz``, stamped with the last
    part's step. Returns ``{gamma as "%.0f": used part indices}``."""
    used = {}
    for gamma in GAMMAS:
        suffix = experiment_suffix(1.0, gamma, False)
        (mean, bin_widths, last_step, indices) = average_gamma_params(
            os.path.join(results_root, suffix), gamma, k, device)
        out_dir = os.path.join(avg_root, suffix)
        save_params_artifact(os.path.join(out_dir, "params_trained.npz"),
                             params_from_jax(mean), bin_widths, step=last_step)
        used[f"{gamma:.0f}"] = indices
        print(f"gamma {gamma:>8.0f}: averaged parts {indices} "
              f"(last step {last_step}) -> {out_dir}")
    return used


def copy_anchor_caches(study_dir, out):
    """Copies the main study's anchor caches into ``out``. They are keyed
    by backend / encoder, ladder and the images' content hash, so a
    copied file stays valid."""
    os.makedirs(out, exist_ok=True)
    for path in (glob.glob(os.path.join(study_dir, "*_hevc_*.npy"))
                 + glob.glob(os.path.join(study_dir, "*_jpeg2000_*.npy"))):
        dst = os.path.join(out, os.path.basename(path))
        if not os.path.isfile(dst):
            shutil.copy(path, dst)


def evaluation_argv(args):
    """``cli/reconstruct_kodak``'s arguments for the averaged models.
    ``--idx_training 999`` names no checkpoint, so the study falls back
    to the params exports under ``--avg_root``."""
    argv = ["--results_root", args.avg_root,
            "--cache_dir", args.out,
            "--path_to_kodak", args.path_to_kodak,
            "--idx_training", "999",
            "--device", args.device]
    if args.hevc_encoder and os.path.isfile(args.hevc_encoder):
        argv += ["--hevc_encoder", args.hevc_encoder]
        if args.hevc_qps:
            argv += ["--hevc_qps"] + [str(q) for q in args.hevc_qps]
    return argv


def evaluate(args, draw=True):
    """The RD study on the averaged models; the figures too unless
    ``draw`` is false (they need matplotlib). Returns the study."""
    study = reconstruct_kodak.compute(evaluation_argv(args))
    if draw:
        reconstruct_kodak.draw(study)
    return study


def write_comparison(k, used, study_dir, out):
    """Writes ``<out>/stability_comparison.json``: the one-model-per-gamma
    entries of both ``dictionary_bjontegaard.pkl`` files side by side.
    Returns the comparison."""
    comparison = {"k": k, "averaged_parts": used}
    for (side, directory) in (("last_checkpoint", study_dir), ("k_checkpoint_average", out)):
        path = os.path.join(directory, "dictionary_bjontegaard.pkl")
        if os.path.isfile(path):
            with open(path, "rb") as file:
                summary = pickle.load(file)
            comparison[side] = {
                key: (value if isinstance(value, (int, float)) else value["delta_pct"])
                for (key, value) in summary.items()
                if key.startswith("EAE one model")}
    path_out = os.path.join(out, "stability_comparison.json")
    with open(path_out, "w") as file:
        json.dump(comparison, file, indent=2)
    print(f"stability comparison written to {path_out}:")
    print(json.dumps(comparison, indent=2))
    return comparison


def build_parser():
    parser = argparse.ArgumentParser(description="Checkpoint-averaging stability study.")
    parser.add_argument("--k", type=int, default=3,
                        help="number of tail checkpoints to average")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--avg_root", default="results/eae_avg")
    parser.add_argument("--study_dir", default="results/eae/kodak_rd",
                        help="the main study's cache dir (its pickle is the "
                             "last-checkpoint side; its anchor caches are "
                             "copied so HM/JPEG2000 are not recomputed)")
    parser.add_argument("--out", default="results/eae/kodak_rd_stability")
    parser.add_argument("--path_to_kodak", default="data/campaign/kodak.npy")
    parser.add_argument("--hevc_encoder",
                        default="build/HM-16.15/bin/TAppEncoderStatic")
    parser.add_argument("--hevc_qps", type=int, nargs="*", default=None)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    used = export_averages(args.results_root, args.avg_root, args.k, device=args.device)
    copy_anchor_caches(args.study_dir, args.out)
    evaluate(args)
    write_comparison(args.k, used, args.study_dir, args.out)


if __name__ == "__main__":
    main()
