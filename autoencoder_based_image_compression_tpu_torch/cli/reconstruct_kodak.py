"""Full rate-distortion evaluation on Kodak (or BSDS), on the card
unless ``--device cpu`` is given.

Counterpart of ``kodak_tensorflow/reconstructing_eae_kodak.py``: builds
the three learned-codec RD curve families plus the JPEG2000 and HEVC
anchors, then the Bjontegaard summaries. Hyperparameter ladder from
``reconstructing_eae_kodak.py:607-660``: gammas {10k..96k} for the
one-model-per-rate family, multipliers {1..10} for the single-model
sweeps, JPEG2000 qualities {24..40}, HEVC QPs {22..47}.

:func:`compute` runs the study (models, curve families, anchors, caches,
the Bjontegaard pickle) and returns what the figures show; :func:`draw`
writes the figures with matplotlib. :func:`main` calls both, so a
machine without matplotlib can still run :func:`compute`.
"""

import argparse
import collections
import hashlib
import os
import pickle

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.eval import rd_sweep
from autoencoder_based_image_compression_tpu_torch.ops.metrics import (
    bjontegaard_fit_quality,
    compute_bjontegaard,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    load_params_artifact,
    params_artifact_step,
    params_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import (
    experiment_suffix,
    float_to_str,
)
from autoencoder_based_image_compression_tpu_torch.utils.parsing import int_strictly_positive

GAMMAS_VARY = [10000.0, 12000.0, 16000.0, 24000.0, 40000.0, 72000.0, 96000.0]
MULTIPLIERS = [1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0]
# JPEG2000 ladder: the anchor defaults to ImageMagick at the
# reference's -quality {24..40} sweep when magick is installed, and to
# Pillow/OpenJPEG compression ratios covering the same 0.1-1.2 bpp
# operating range otherwise (codecs/jpeg2000.evaluate_jpeg2000).
HEVC_QPS = [22, 27, 32, 37, 42, 47]


_EvalModel = collections.namedtuple("_EvalModel", ["params", "bin_widths", "step"])
# What :func:`compute` returns: ``curves`` is a list of ``(mean rates,
# mean PSNRs, label, style)``; ``families`` maps each EAE label to its
# per-point, per-image arrays ``(rates, psnrs)`` or, for a multiplier
# sweep, ``(rates, psnrs, nb_deads)``; ``summaries`` is what
# ``dictionary_bjontegaard.pkl`` holds.
Study = collections.namedtuple("Study", ["curves", "families", "summaries", "title",
                                         "cache_dir"])
# The dead-feature-maps-vs-rate figure of each multiplier sweep
# (reference ``reconstructing_eae_kodak.py:245-287``).
DEAD_MAP_FIGURES = {"EAE learned bin widths": "nb_dead_learn_bw.png",
                    "EAE fixed bin widths": "nb_dead_fixed_bw.png"}


def _load_state(results_root, bin_width_init, gamma, learn_bin_widths, idx_training,
                device):
    """Loads a model for the test-time sweep.

    Prefers the train-state checkpoint ``model_{idx_training}``; falls
    back to the experiment's version-controlled ``params_trained.npz``
    export (the sweep only needs params + bin widths + the step for the
    cache key, so the repo's committed artifacts are enough to
    regenerate every curve without the untracked optimizer state).
    Returns an ``_EvalModel``: parameter tensors on ``device``, numpy bin
    widths and the step (an int, or a content-hash string for an
    un-stamped export), or None when neither file is there.
    """
    exp_dir = os.path.join(results_root,
                           experiment_suffix(bin_width_init, gamma, learn_bin_widths))
    path = os.path.join(exp_dir, f"model_{idx_training}")
    if checkpoint_exists(path):
        template = init_train_state(torch.Generator().manual_seed(0), bin_width_init,
                                    learn_bin_widths, device=device)
        state = load_checkpoint(path, template)
        return _EvalModel(state.params, state.bin_widths.cpu().numpy(), int(state.step))
    path_artifact = os.path.join(exp_dir, "params_trained.npz")
    if os.path.isfile(path_artifact):
        (params, bin_widths) = load_params_artifact(path_artifact)
        step = params_artifact_step(path_artifact)
        if step is None:
            # Pre-step-stamp export: a constant placeholder would make
            # every un-stamped artifact share one cache key (and
            # silently reuse another export's cached RD curves), so the
            # cache token is derived from the artifact's content.
            with open(path_artifact, "rb") as file:
                step = "x" + hashlib.sha1(file.read()).hexdigest()[:10]
        print(f"{path} not found: using the params export {path_artifact} "
              f"(step {step}).")
        params = {name: value.to(device)
                  for (name, value) in params_from_jax(params).items()}
        return _EvalModel(params, bin_widths, step)
    return None


def _step_key(step):
    """Cache-key token for a model's training step (int for real
    checkpoints, content-hash string for un-stamped params exports)."""
    return step if isinstance(step, str) else str(int(step))


def build_parser():
    parser = argparse.ArgumentParser(description="Kodak RD evaluation.")
    parser.add_argument("--idx_training", type=int_strictly_positive, default=1)
    parser.add_argument("--batch_size", type=int_strictly_positive, default=4)
    parser.add_argument("--code_lossless", action="store_true",
                        help="true coded rate via the C++ arithmetic coder")
    parser.add_argument("--use_bsds", action="store_true")
    parser.add_argument("--path_to_kodak", default="data/kodak/kodak.npy")
    parser.add_argument("--path_to_bsds", default="data/bsds/bsds.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--cache_dir", default="results/rd")
    parser.add_argument("--hevc_encoder", default="",
                        help="path to HM TAppEncoderStatic (optional)")
    parser.add_argument("--hevc_qps", type=int, nargs="*", default=None,
                        help=f"HM QP ladder (default {HEVC_QPS}, the "
                             "reference's; extend toward 51 when the "
                             "content codes far below the reference's "
                             "operating range)")
    parser.add_argument("--jpeg2000_backend", default="auto",
                        choices=["auto", "pillow", "imagemagick"],
                        help="JPEG2000 anchor backend; 'auto' prefers "
                             "ImageMagick (the reference's) when installed")
    parser.add_argument("--jpeg2000_ladder", "--jpeg2000_ratios",
                        dest="jpeg2000_ladder",
                        type=float, nargs="*", default=None,
                        help="JPEG2000 sweep values. Semantics depend on the "
                             "backend: ImageMagick -quality settings "
                             "(reference ladder {24..40}) for "
                             "'imagemagick', Pillow/OpenJPEG compression "
                             "ratios for 'pillow'. Explicit values force "
                             "--jpeg2000_backend to be given (not 'auto') "
                             "so the ladder cannot be reinterpreted by the "
                             "other backend. Default: the backend's "
                             "reference-range ladder.")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    parser.add_argument("--write_ref", action="store_true",
                        help="save the reference luminance images as PNGs "
                             "(rotated back per list_rotation.pkl)")
    return parser


def compute(args=None):
    """Everything the study does but draw: loads the models, runs the
    three EAE families and the anchors through their caches, prints the
    study's lines, writes every cache file and
    ``dictionary_bjontegaard.pkl``; returns a :class:`Study`. ``args``
    is the command line's argument list."""
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)

    # Bare ``--hevc_qps`` / ``--jpeg2000_ladder`` (nargs="*" with zero
    # values) mean "use the default ladder", not an empty sweep.
    if not args.hevc_qps:
        args.hevc_qps = None
    if not args.jpeg2000_ladder:
        args.jpeg2000_ladder = None
    elif args.jpeg2000_backend == "auto":
        # Explicit values are backend-specific (ImageMagick -quality vs
        # Pillow compression ratios); 'auto' must not reinterpret them
        # depending on what is installed, so they pin the Pillow
        # backend unless one was named.
        print("--jpeg2000_ladder given without --jpeg2000_backend: "
              "interpreting the values as Pillow/OpenJPEG compression "
              "ratios (pass --jpeg2000_backend imagemagick for -quality "
              "semantics).")
        args.jpeg2000_backend = "pillow"

    images = numpy.load(args.path_to_bsds if args.use_bsds else args.path_to_kodak)

    if args.write_ref:
        # Reference ``reconstructing_eae_kodak.py:558-589``: persists the
        # uncompressed references, undoing the dataset-build rotation.
        from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

        ref_dir = os.path.join(args.cache_dir, "reference")
        os.makedirs(ref_dir, exist_ok=True)
        path_rotation = os.path.join(
            os.path.dirname(args.path_to_bsds if args.use_bsds else args.path_to_kodak),
            "list_rotation.pkl")
        list_rotation = []
        if os.path.isfile(path_rotation):
            with open(path_rotation, "rb") as file:
                list_rotation = pickle.load(file)
        for i in range(images.shape[0]):
            luminance = images[i]
            if i in list_rotation:
                luminance = numpy.rot90(luminance, k=-1)
            save_image(os.path.join(ref_dir, f"reference_{i}.png"), luminance)
        print(f"reference images written to {ref_dir}")
    curves = []
    families = {}

    # Family 1: one fixed-bw model per gamma, unit bin widths.
    params_per_gamma = {}
    step_per_gamma = {}
    for gamma in GAMMAS_VARY:
        state = _load_state(args.results_root, 1.0, gamma, False, args.idx_training,
                            device)
        if state is not None:
            params_per_gamma[gamma] = state.params
            step_per_gamma[gamma] = _step_key(state.step)
    if params_per_gamma:
        # Cache key carries the full model identity: which gammas, at
        # which training steps (stale-curve guard).
        vary_id = "g" + "-".join(
            f"{float_to_str(g)}s{step_per_gamma[g]}"
            for g in sorted(params_per_gamma))
        (rates_v, psnrs_v) = rd_sweep.vary_gamma_fix_bin_widths(
            images, params_per_gamma, sorted(params_per_gamma), args.batch_size,
            args.cache_dir, experiment_id=vary_id)
        curves.append((numpy.mean(rates_v, axis=1), numpy.mean(psnrs_v, axis=1),
                       "EAE one model per gamma", "o-"))
        families["EAE one model per gamma"] = (rates_v, psnrs_v)

    # Families 2+3: single model, multiplier sweep (learned / fixed bw).
    for (learn_bw, bw_init, label, style) in [
            (True, 0.5, "EAE learned bin widths", "s-"),
            (False, 1.0, "EAE fixed bin widths", "^-")]:
        state = _load_state(args.results_root, bw_init, 10000.0, learn_bw,
                            args.idx_training, device)
        if state is None:
            continue
        stats_dir = os.path.join(args.results_root,
                                 experiment_suffix(bw_init, 10000.0, learn_bw),
                                 "statistics")
        map_mean = probabilities = None
        idx_exception = -1
        if os.path.isfile(os.path.join(stats_dir, "map_mean.npy")):
            map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
            with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
                idx_exception = pickle.load(file)
            if args.code_lossless:
                probabilities = [
                    numpy.load(os.path.join(
                        stats_dir,
                        f"binary_probabilities_{float_to_str(m)}.npy"))
                    for m in MULTIPLIERS]
        # Cache key = model identity (bw init, gamma, training step),
        # multiplier ladder, and true-coded vs theoretical rate.
        fix_id = (f"{float_to_str(bw_init)}_{float_to_str(10000.0)}"
                  f"_s{_step_key(state.step)}"
                  f"_m{'-'.join(float_to_str(m) for m in MULTIPLIERS)}"
                  f"_{'coded' if probabilities is not None else 'approx'}")
        (rates_f, psnrs_f, nb_deads_f) = rd_sweep.fix_gamma(
            images, state.params, state.bin_widths, learn_bw,
            MULTIPLIERS, args.batch_size, args.cache_dir, map_mean, probabilities,
            idx_exception, experiment_id=fix_id)
        curves.append((numpy.mean(rates_f, axis=1), numpy.mean(psnrs_f, axis=1),
                       label, style))
        families[label] = (rates_f, psnrs_f, nb_deads_f)

    # Anchors. Both are cached like the EAE curve families (the
    # reference caches every family, ``reconstructing_eae_kodak.py:678-683``;
    # anchor recomputation dominated study-regeneration time). The cache
    # key carries the resolved backend, the resolved ladder and a
    # content hash of the image stack, so changing any of them recomputes.
    images_tag = hashlib.sha1(images.tobytes()).hexdigest()[:10]

    def _cached_anchor(tag, run):
        path_rates = os.path.join(args.cache_dir, f"rates_{tag}.npy")
        path_psnrs = os.path.join(args.cache_dir, f"psnrs_{tag}.npy")
        if os.path.isfile(path_rates) and os.path.isfile(path_psnrs):
            return (numpy.load(path_rates), numpy.load(path_psnrs))
        (rates, psnrs) = run()
        os.makedirs(args.cache_dir, exist_ok=True)
        numpy.save(path_rates, rates)
        numpy.save(path_psnrs, psnrs)
        return (rates, psnrs)

    try:
        from autoencoder_based_image_compression_tpu_torch.codecs.jpeg2000 import (
            DEFAULT_RATIOS,
            REFERENCE_QUALITIES,
            evaluate_jpeg2000,
            imagemagick_available,
        )

        backend = args.jpeg2000_backend
        if backend == "auto":
            backend = "imagemagick" if imagemagick_available() else "pillow"
        ladder = args.jpeg2000_ladder
        if ladder is None:
            ladder = list(REFERENCE_QUALITIES if backend == "imagemagick"
                          else DEFAULT_RATIOS)
        j2k_tag = (f"jpeg2000_{backend}_"
                   f"{'-'.join(float_to_str(float(v)) for v in ladder)}"
                   f"_{images_tag}")
        (rates_j2k, psnrs_j2k) = _cached_anchor(
            j2k_tag,
            lambda: evaluate_jpeg2000(images, ratios=ladder, backend=backend))
        curves.append((numpy.mean(rates_j2k, axis=0), numpy.mean(psnrs_j2k, axis=0),
                       "JPEG2000", "x--"))
    except Exception as error:  # anchor optional
        print(f"JPEG2000 anchor skipped: {error}")
        rates_j2k = None
    if args.hevc_encoder:
        from autoencoder_based_image_compression_tpu_torch.codecs.hevc import evaluate_hevc

        qps = HEVC_QPS if args.hevc_qps is None else args.hevc_qps
        # The cache tag folds in the encoder binary's identity (content
        # hash) the way the JPEG2000 tag folds in its backend: switching
        # HM builds must not silently reuse stale curves.
        try:
            digest = hashlib.sha1()
            with open(args.hevc_encoder, "rb") as file:
                for chunk in iter(lambda: file.read(1 << 20), b""):
                    digest.update(chunk)
            encoder_id = digest.hexdigest()[:10]
        except OSError:
            encoder_id = "missing"
        hevc_tag = (f"hevc_{encoder_id}_"
                    f"qp{'-'.join(str(q) for q in qps)}_{images_tag}")
        (rates_hevc, psnrs_hevc) = _cached_anchor(
            hevc_tag,
            lambda: evaluate_hevc(images, qps, args.hevc_encoder))
        curves.append((numpy.mean(rates_hevc, axis=0), numpy.mean(psnrs_hevc, axis=0),
                       "HEVC", "d--"))

    os.makedirs(args.cache_dir, exist_ok=True)
    if curves:
        print(f"{len(curves)} RD curves written to {args.cache_dir}")
    else:
        print("No trained checkpoints found; nothing to evaluate.")

    # Bjontegaard summaries: each EAE family vs each anchor, pickled
    # like the reference's dictionary_bjontegaard_* artifacts
    # (reconstructing_eae_kodak.py:837-856). Needs >=4 RD points per
    # curve for the cubic fit.
    anchors = [(label, r, p) for (r, p, label, _) in curves
               if label in ("JPEG2000", "HEVC")]
    eae_curves = [(label, r, p) for (r, p, label, _) in curves
                  if label.startswith("EAE")]
    summaries = {}
    for (eae_label, eae_r, eae_p) in eae_curves:
        for (anchor_label, anchor_r, anchor_p) in anchors:
            if len(eae_r) < 4 or len(anchor_r) < 4:
                continue
            overlap = (min(numpy.max(eae_p), numpy.max(anchor_p))
                       - max(numpy.min(eae_p), numpy.min(anchor_p)))
            if overlap <= 0.5:  # dB; the cubic-fit integral needs real overlap
                print(f"Bjontegaard {eae_label} vs {anchor_label}: skipped "
                      f"(PSNR ranges overlap by {overlap:.2f} dB)")
                continue
            try:
                delta = compute_bjontegaard(anchor_r, anchor_p, eae_r, eae_p,
                                            warn=False)
            except Exception as error:
                print(f"Bjontegaard {eae_label} vs {anchor_label} failed: {error}")
                continue
            # The pickle carries the fit-quality flags next to every
            # number (overlap width + cubic monotonicity), so that the
            # cubic fit's instability is visible wherever the summary
            # circulates.
            quality = bjontegaard_fit_quality(anchor_r, anchor_p, eae_r, eae_p)
            summaries[f"{eae_label} vs {anchor_label}"] = {
                "delta_pct": delta, "fit_quality": quality}
            caveat = ("" if quality["reliable"]
                      else "  [fit quality: "
                           f"overlap {quality['overlap_db']:.2f} dB"
                           f"{', narrow' if quality['narrow_overlap'] else ''}"
                           f"{'' if quality['monotone_0'] else ', anchor cubic non-monotone'}"
                           f"{'' if quality['monotone_1'] else ', EAE cubic non-monotone'}"
                           "]")
            print(f"Bjontegaard {eae_label} vs {anchor_label}: "
                  f"{delta:+.2f}% bitrate{caveat}")
    if summaries:
        with open(os.path.join(args.cache_dir, "dictionary_bjontegaard.pkl"),
                  "wb") as file:
            pickle.dump(summaries, file)
    return Study(curves, families, summaries,
                 "Rate-distortion on " + ("BSDS" if args.use_bsds else "Kodak"), args.cache_dir)


def draw(study):
    """Writes the figures of a :class:`Study` into its cache directory:
    ``nb_dead_{learn,fixed}_bw.png`` and ``rate_distortion.png``."""
    from autoencoder_based_image_compression_tpu_torch.eval.visualization import (
        plot_nb_dead_feature_maps,
    )

    for (label, name) in DEAD_MAP_FIGURES.items():
        if label in study.families:
            (rates, _, nb_deads) = study.families[label]
            plot_nb_dead_feature_maps(rates, nb_deads, os.path.join(study.cache_dir, name))
    if study.curves:
        rd_sweep.plot_rate_distortion(study.curves, study.title,
                                      os.path.join(study.cache_dir, "rate_distortion.png"))


def main(args=None):
    draw(compute(args))


if __name__ == "__main__":
    main()
