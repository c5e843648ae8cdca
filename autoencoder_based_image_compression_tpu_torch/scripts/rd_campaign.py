"""End-to-end Kodak rate-distortion campaign, on the card unless
``--device cpu`` is given.

Reproduces the reference's flagship experiment
(``kodak_tensorflow/reconstructing_eae_kodak.py:591-856``) from scratch,
with every model trained here:

1. builds the synthetic ImageNet-like training / validation / extra
   stacks and the synthetic Kodak-shaped test set (:func:`build_data`;
   the shapes, BT.601 range and seeds 11-14 are the reference package's
   campaign's, so both packages train and test on the same bytes),
2. trains the one-model-per-gamma ladder (fixed unit bin widths, gamma in
   {10k..96k}, ``reconstructing_eae_kodak.py:607-611``) plus the
   learned-bin-width (delta_init 0.5) gamma=10000 model for the
   multiplier sweeps, in ``--nb_parts`` resumable parts
   (:func:`train_parts`); the fixed-bin-width gamma=10000 ladder entry is
   the fixed-bin-width sweep model,
3. collects the extra-set coding statistics of both sweep models
   (:func:`collect_stats`),
4. exports every trained model as a step-stamped ``params_trained.npz``
   (:func:`export_params`),
5. runs the RD evaluation with true coded rates through the C++
   arithmetic coder (``cli/reconstruct_kodak --code_lossless``), the
   JPEG2000 anchor and the Bjontegaard summaries, writing
   ``rate_distortion.png`` and ``dictionary_bjontegaard.pkl`` under
   ``--out`` (:func:`evaluate`).

Resumable: finished parts, statistics and cached curves are skipped on a
re-run, like the reference's file-existence guards. Each stage is a
function, so a caller can run them one by one.

Usage::

    python -m autoencoder_based_image_compression_tpu_torch.scripts.rd_campaign \\
        [--nb_parts 1] [--ladder_vmap] [--out results/eae/kodak_rd] [--device cuda]
"""

import argparse
import glob
import json
import os
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.cli import collect_stats as cs
from autoencoder_based_image_compression_tpu_torch.cli import (
    reconstruct_kodak,
    train_eae,
    train_ladder,
)
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_kodak,
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    checkpoint_part_complete,
    load_checkpoint,
    save_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

GAMMAS_VARY = [10000.0, 12000.0, 16000.0, 24000.0, 40000.0, 72000.0, 96000.0]
# The learned-bin-width sweep model: (bin width init, gamma, learned).
LEARNED = (0.5, 10000.0, True)


def _ensure_stack(path, expected_shape, build):
    """Reuses ``path`` only when its shape matches the requested config.

    A stale stack (e.g. a --smoke run's 64x64/40-image data left in the
    same --data_root) is regenerated instead of silently training the
    whole gamma ladder on it.
    """
    if os.path.isfile(path):
        existing = numpy.load(path, mmap_mode="r")
        if tuple(existing.shape) == tuple(expected_shape):
            return
        print(f"[campaign] {path}: shape {tuple(existing.shape)} does not "
              f"match the requested {tuple(expected_shape)}; regenerating")
        del existing
    numpy.save(path, build())


def build_data(root, nb_training, nb_validation, nb_extra, crop, kodak_shape):
    """Synthetic stacks with the reference sets' shapes, saved once
    (shape-validated against the requested config on reuse). Returns the
    paths by role: training, validation, extra, kodak."""
    os.makedirs(root, exist_ok=True)
    paths = {
        "training": os.path.join(root, "training_data.npy"),
        "validation": os.path.join(root, "validation_data.npy"),
        "extra": os.path.join(root, "extra_data.npy"),
        "kodak": os.path.join(root, "kodak.npy"),
    }
    for (role, nb, seed) in (("training", nb_training, 11), ("validation", nb_validation, 12),
                             ("extra", nb_extra, 13)):
        _ensure_stack(paths[role], (nb, crop, crop, 1),
                      lambda nb=nb, seed=seed: synthetic_luminance_stack(nb, crop, crop,
                                                                         seed=seed))

    def _build_kodak():
        if tuple(kodak_shape) == (24, 512, 768):
            return synthetic_kodak(seed=14)[..., 0]
        (nb, h, w) = kodak_shape
        return synthetic_luminance_stack(nb, h, w, seed=14)[..., 0]

    _ensure_stack(paths["kodak"], kodak_shape, _build_kodak)
    return paths


def _part_done(path):
    """Finished-part check: the checkpoint exists AND its part ran to
    completion (the command lines save every epoch, so existence alone
    would accept an interrupted part's last epoch as a trained model)."""
    if not checkpoint_exists(path):
        # A metadata file without its array file is a leftover of an
        # interrupted part whose npz was already cleaned up; remove it
        # so no consumer (collect_stats' step marker, resume logic)
        # mistakes it for a trained model.
        if os.path.isfile(path + ".json"):
            print(f"[campaign] {path}.json: orphan checkpoint metadata "
                  "(no .npz); removing it")
            os.remove(path + ".json")
        return False
    if checkpoint_part_complete(path):
        return True
    print(f"[campaign] {path}: interrupted part detected; retraining it")
    for ext in (".npz", ".json"):
        if os.path.isfile(path + ext):
            os.remove(path + ext)
    return False


def train_one(results_root, paths, bw_init, gamma, learn_bw, nb_epochs, batch_size,
              idx_part=0, device="cuda"):
    """One resumable training part through ``cli/train_eae`` (skipped if
    its checkpoint is a finished part). Returns its seconds, or None
    when it was skipped."""
    suffix = experiment_suffix(bw_init, gamma, learn_bw)
    if _part_done(os.path.join(results_root, suffix, f"model_{idx_part + 1}")):
        print(f"[campaign] {suffix}: model_{idx_part + 1} exists, skipping training")
        return None
    argv = [str(bw_init), str(gamma), str(idx_part),
            "--nb_epochs_training", str(nb_epochs),
            "--batch_size", str(batch_size),
            "--path_to_training_data", paths["training"],
            "--path_to_validation_data", paths["validation"],
            "--results_root", results_root,
            "--device", device]
    if learn_bw:
        argv.append("--learn_bin_widths")
    t0 = time.time()
    train_eae.main(argv)
    seconds = time.time() - t0
    print(f"[campaign] {suffix}: part {idx_part} trained in {seconds:.1f} s")
    return seconds


def train_ladder_part(results_root, paths, gammas, nb_epochs, batch_size, idx_part,
                      device="cuda"):
    """One part of the whole fixed-bin-width ladder as one stacked ladder
    state through ``cli/train_ladder`` (a loop over the models' slices a
    step). Returns its seconds, or None when every model had the part.

    Falls back to per-model training when the ladder is in a mixed
    resume state (some gammas already have this part's checkpoint)."""
    missing = [g for g in gammas if not _part_done(
        os.path.join(results_root, experiment_suffix(1.0, g, False), f"model_{idx_part + 1}"))]
    if not missing:
        print(f"[campaign] ladder: part {idx_part} exists for all gammas, skipping")
        return None
    if len(missing) != len(gammas):
        print(f"[campaign] ladder: mixed resume state (missing {missing}); "
              "training the missing models individually")
        t0 = time.time()
        for gamma in missing:
            train_one(results_root, paths, 1.0, gamma, False, nb_epochs, batch_size, idx_part,
                      device)
        return time.time() - t0
    t0 = time.time()
    train_ladder.main([
        "1.0", str(idx_part),
        "--gammas"] + [str(g) for g in gammas] + [
        "--nb_epochs_training", str(nb_epochs),
        "--batch_size", str(batch_size),
        "--path_to_training_data", paths["training"],
        "--path_to_validation_data", paths["validation"],
        "--results_root", results_root,
        "--device", device])
    seconds = time.time() - t0
    print(f"[campaign] ladder: part {idx_part} ({len(gammas)} models, one stacked ladder "
          f"state through cli/train_ladder, a loop over slices) trained in {seconds:.1f} s")
    return seconds


def train_parts(args, paths):
    """Every training part of the campaign, part after part: the fixed
    ladder (as one ladder with ``--ladder_vmap``, else model by model),
    then the learned-bin-width model. Returns ``{label: seconds}`` of the
    parts that trained."""
    seconds = {}
    for idx_part in range(args.nb_parts):
        if args.ladder_vmap:
            seconds[f"ladder part {idx_part}"] = train_ladder_part(
                args.results_root, paths, args.gammas_trained, args.nb_epochs,
                args.batch_size, idx_part, args.device)
        else:
            for gamma in args.gammas_trained:
                seconds[f"gamma {gamma:.0f} part {idx_part}"] = train_one(
                    args.results_root, paths, 1.0, gamma, False, args.nb_epochs,
                    args.batch_size, idx_part, args.device)
        seconds[f"learned-bw part {idx_part}"] = train_one(
            args.results_root, paths, *LEARNED, args.nb_epochs, args.batch_size, idx_part,
            args.device)
    return {label: s for (label, s) in seconds.items() if s is not None}


def collect_stats(results_root, paths, bw_init, gamma, learn_bw, idx_model, device="cuda"):
    """Extra-set statistics for model_{idx_model} (re-collected whenever
    the model index advances - the reference regenerates them for any
    retrained model, ``collecting_stats_eae_extra.py:4-7``)."""
    suffix = experiment_suffix(bw_init, gamma, learn_bw)
    exp_dir = os.path.join(results_root, suffix)
    stats_dir = os.path.join(exp_dir, "statistics")
    marker = os.path.join(stats_dir, "stats_model_idx.json")
    if os.path.isfile(os.path.join(stats_dir, "map_mean.npy")):
        recorded = -1
        if os.path.isfile(marker):
            with open(marker) as file:
                recorded = json.load(file).get("idx_model", -1)
        if recorded == idx_model:
            print(f"[campaign] {suffix}: statistics for model_{idx_model} exist, skipping")
            return
    # Stale statistics (an earlier model's) must be deleted before the
    # recollection: cli/collect_stats keeps the reference's
    # file-existence guard (lossless/stats.py:294-297) and would
    # silently skip, leaving the marker claiming a model the files do
    # not come from.
    if os.path.isdir(stats_dir):
        for stale in (glob.glob(os.path.join(stats_dir, "binary_probabilities_*.npy"))
                      + [os.path.join(stats_dir, "map_mean.npy"),
                         os.path.join(stats_dir, "idx_map_exception.pkl")]):
            if os.path.isfile(stale):
                os.remove(stale)
    argv = [str(bw_init), str(gamma), str(idx_model),
            "--path_to_extra_data", paths["extra"],
            "--results_root", results_root,
            "--device", device]
    if learn_bw:
        argv.append("--learn_bin_widths")
    cs.main(argv)
    # The marker records which model (and its training step, from the
    # checkpoint meta) the statistics were collected from, so consumers
    # pairing them with a params export can detect a mismatched pair.
    # The metadata is only trusted when its array file exists: a stale
    # json without the npz must not stamp the statistics with a step the
    # weights never reached.
    step = None
    meta_path = os.path.join(exp_dir, f"model_{idx_model}.json")
    if (os.path.isfile(meta_path)
            and os.path.isfile(os.path.join(exp_dir, f"model_{idx_model}.npz"))):
        with open(meta_path) as file:
            step = json.load(file).get("step")
    os.makedirs(stats_dir, exist_ok=True)
    with open(marker, "w") as file:
        json.dump({"idx_model": idx_model, "step": step}, file)
    print(f"[campaign] {suffix}: statistics collected (model_{idx_model}, step {step})")


def export_params(results_root, gammas_trained, idx_model, device="cuda"):
    """Step-stamped params-only exports (``params_trained.npz``) of every
    trained model's ``model_{idx_model}``: the learned-bin-width sweep
    model and each fixed-bin-width gamma. The full checkpoints carry
    optimiser state and stay untracked; the exports make the whole RD
    study reproducible from the repository alone (``reconstruct_kodak``
    falls back to them when the checkpoints are gone)."""
    exports = [LEARNED] + [(1.0, gamma, False) for gamma in sorted(gammas_trained)]
    for (bw_init, gamma, learn_bw) in exports:
        exp_dir = os.path.join(results_root, experiment_suffix(bw_init, gamma, learn_bw))
        template = init_train_state(torch.Generator().manual_seed(0), bw_init, learn_bw,
                                    device=device)
        state = load_checkpoint(os.path.join(exp_dir, f"model_{idx_model}"), template)
        save_params_artifact(os.path.join(exp_dir, "params_trained.npz"), state.params,
                             state.bin_widths, step=int(state.step))


def evaluation_argv(args, paths):
    """The ``cli/reconstruct_kodak`` arguments of the campaign's study."""
    argv = [
        "--idx_training", str(args.nb_parts),
        "--code_lossless",
        "--path_to_kodak", paths["kodak"],
        "--results_root", args.results_root,
        "--cache_dir", args.out,
        "--device", args.device,
    ]
    if args.hevc_encoder:
        argv += ["--hevc_encoder", args.hevc_encoder]
        if args.hevc_qps:
            argv += ["--hevc_qps"] + [str(q) for q in args.hevc_qps]
    if args.jpeg2000_backend != "auto":
        argv += ["--jpeg2000_backend", args.jpeg2000_backend]
    if args.jpeg2000_ladder:
        argv += ["--jpeg2000_ladder"] + [str(r) for r in args.jpeg2000_ladder]
    return argv


def evaluate(args, paths, draw=True):
    """The campaign's RD study; the figures too unless ``draw`` is false
    (they need matplotlib). Returns the study."""
    study = reconstruct_kodak.compute(evaluation_argv(args, paths))
    if draw:
        reconstruct_kodak.draw(study)
    return study


def build_parser():
    parser = argparse.ArgumentParser(description="Kodak RD campaign.")
    parser.add_argument("--data_root", default="data/campaign")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--out", default="results/eae/kodak_rd")
    parser.add_argument("--nb_training", type=int, default=2330)
    parser.add_argument("--nb_validation", type=int, default=100)
    parser.add_argument("--nb_extra", type=int, default=240)
    parser.add_argument("--nb_epochs", type=int, default=30)
    parser.add_argument("--nb_parts", type=int, default=1,
                        help="number of resumable training parts per model "
                             "(each --nb_epochs long)")
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--hevc_encoder", default="")
    parser.add_argument("--hevc_qps", type=int, nargs="*", default=None)
    parser.add_argument("--jpeg2000_backend", default="auto",
                        choices=["auto", "pillow", "imagemagick"])
    parser.add_argument("--jpeg2000_ladder", "--jpeg2000_ratios",
                        dest="jpeg2000_ladder",
                        type=float, nargs="*", default=None,
                        help="backend-specific JPEG2000 sweep values "
                             "(requires an explicit --jpeg2000_backend)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes / 2 epochs on small data - wiring "
                             "check only (run it on the CPU with --device cpu)")
    parser.add_argument("--train_only", action="store_true",
                        help="stop after the training parts (no stats "
                             "recollection, exports or RD evaluation) - for "
                             "running long training continuations in the "
                             "background while the evaluation is driven "
                             "separately")
    parser.add_argument("--gammas", type=float, nargs="*", default=None,
                        help="subset of the gamma ladder to train "
                             f"(default: all of {GAMMAS_VARY})")
    parser.add_argument("--ladder_vmap", action="store_true",
                        help="train the whole fixed-bw gamma family as one "
                             "stacked ladder state a part (cli.train_ladder: "
                             "one loop over the models' slices a step) "
                             "instead of sequential per-gamma runs")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'; "
                             "passed to every command the campaign chains")
    return parser


def parse_args(argv=None):
    """The campaign's arguments with ``--smoke`` applied, plus ``crop``,
    ``kodak_shape`` and ``gammas_trained`` (the requested ladder, with
    10000 added: the fixed-bin-width sweep model is its gamma=10000
    entry, which the statistics, exports and evaluation need)."""
    args = build_parser().parse_args(argv)
    if args.jpeg2000_ladder and args.jpeg2000_backend == "auto":
        # Explicit ladder values are backend-specific; pin Pillow
        # semantics up front (same normalization as reconstruct_kodak).
        args.jpeg2000_backend = "pillow"
    (args.crop, args.kodak_shape) = (256, (24, 512, 768))
    if args.smoke:
        (args.nb_training, args.nb_validation, args.nb_extra) = (40, 20, 20)
        args.nb_epochs = 2
        (args.crop, args.kodak_shape) = (64, (4, 128, 192))
    args.gammas_trained = list(GAMMAS_VARY if args.gammas is None else args.gammas)
    if 10000.0 not in args.gammas_trained:
        args.gammas_trained.append(10000.0)
    return args


def main(argv=None):
    args = parse_args(argv)
    paths = build_data(args.data_root, args.nb_training, args.nb_validation, args.nb_extra,
                       args.crop, args.kodak_shape)
    # Model ladder: the fixed-bw models (one per gamma) + the learned-bw
    # sweep model, each trained in --nb_parts resumable parts (the
    # reference's multi-part scheme, training_eae_imagenet.py:75-96).
    train_parts(args, paths)
    if args.train_only:
        print(f"[campaign] --train_only: {args.nb_parts} parts done, "
              "stopping before stats/exports/evaluation")
        return
    collect_stats(args.results_root, paths, *LEARNED, args.nb_parts, args.device)
    collect_stats(args.results_root, paths, 1.0, 10000.0, False, args.nb_parts, args.device)
    export_params(args.results_root, args.gammas_trained, args.nb_parts, args.device)
    evaluate(args, paths)


if __name__ == "__main__":
    main()
