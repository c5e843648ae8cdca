"""Rate-distortion comparison of the SVHN dense EAE with JPEG / JPEG2000.

Counterpart of ``svhn/reconstructing_eae_svhn.py`` and of the reference
package's ``cli/reconstruct_svhn.py``: evaluates a trained dense EAE over
bin-width multipliers on test digits (rate = nb_y * entropy / 3072, PSNR
after undoing the preprocessing, ``svhn/eae/utils.py:8-80``) and overlays
the JPEG / JPEG2000 quality sweeps of the host codec. The encoder and
decoder run on the device; it encodes without noise, so the table is a
deterministic function of the checkpoint, which either package may have
written.
"""

import argparse
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.data.svhn import (
    preprocess_svhn,
    synthetic_svhn,
)
from autoencoder_based_image_compression_tpu_torch.models import dense_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import load_checkpoint
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import float_strictly_positive

MULTIPLIERS = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)


def _mean_psnr_rows(rows_uint8, rec_rows_uint8):
    ref = rows_uint8.astype(numpy.float64)
    rec = rec_rows_uint8.astype(numpy.float64)
    mse = numpy.mean((ref - rec) ** 2, axis=1)
    return float(numpy.mean(10.0 * numpy.log10((255.0 ** 2) / mse)))


def main(args=None):
    parser = argparse.ArgumentParser(description="SVHN RD comparison.")
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("gamma", type=float_strictly_positive)
    parser.add_argument("--learn_bin_width", action="store_true")
    parser.add_argument("--path_to_test_data", default="data/svhn/test_data.npy")
    parser.add_argument("--results_root", default="results/svhn")
    parser.add_argument("--nb_digits", type=int, default=250)
    parser.add_argument("--plot", action="store_true",
                        help="write rate_distortion.png under the experiment "
                             "directory (the reference's checked-in figure, "
                             "svhn/eae/visualization/test/checking_reconstructing)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    exp_dir = os.path.join(args.results_root,
                           experiment_suffix(args.bin_width_init, args.gamma,
                                             args.learn_bin_width))
    stats = numpy.load(os.path.join(exp_dir, "preprocessing.npz"))
    template = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(0),
                                              args.bin_width_init, device=device)
    state = load_checkpoint(os.path.join(exp_dir, "model"), template)

    if os.path.isfile(args.path_to_test_data):
        test_uint8 = numpy.load(args.path_to_test_data)[:args.nb_digits]
    else:
        test_uint8 = synthetic_svhn(args.nb_digits, seed=99)
        print("using synthetic SVHN digits")
    test = preprocess_svhn(test_uint8, stats["mean_training"],
                           float(stats["std_training"]))

    print("multiplier  rate(bpp)  PSNR(dB)")
    eae_rates = []
    eae_psnrs = []
    for multiplier in MULTIPLIERS:
        bin_width_test = multiplier * float(state.bin_width)
        (rate, rec_uint8) = dense_eae.compute_rate_psnr(
            state, test, stats["mean_training"], float(stats["std_training"]),
            bin_width_test)
        psnr = _mean_psnr_rows(test_uint8, rec_uint8)
        eae_rates.append(rate)
        eae_psnrs.append(psnr)
        print(f"{multiplier:9.2f}  {rate:9.4f}  {psnr:8.3f}")

    curves = [(numpy.asarray(eae_rates), numpy.asarray(eae_psnrs),
               "EAE " + ("learned bin width" if args.learn_bin_width
                         else "fixed bin width"), "s-")]
    # The anchors are host codecs: a missing codec skips them, as in the
    # reference package.
    try:
        from autoencoder_based_image_compression_tpu_torch.codecs.jpeg import evaluate_jpeg

        for (name, codec, sweep, style) in (
                ("JPEG", "jpeg", list(range(10, 95, 10)), "x--"),
                ("JPEG2000", "jpeg2000", [24, 16, 12, 8, 6, 4], "d--")):
            (rates, psnrs) = evaluate_jpeg(test_uint8[:50], sweep, codec=codec)
            curves.append((rates, psnrs, name, style))
            print(f"{name} anchor: rates {numpy.round(rates, 3)} "
                  f"psnrs {numpy.round(psnrs, 2)}")
    except Exception as error:
        print(f"JPEG anchors skipped: {error}")

    if args.plot:
        from autoencoder_based_image_compression_tpu_torch.eval.rd_sweep import (
            plot_rate_distortion)

        path_figure = os.path.join(exp_dir, "rate_distortion.png")
        plot_rate_distortion(curves, "Rate-distortion on SVHN test digits",
                             path_figure)
        numpy.savez(os.path.join(exp_dir, "rate_distortion.npz"),
                    **{f"{label}_rates": r for (r, _, label, _) in curves},
                    **{f"{label}_psnrs": p for (_, p, label, _) in curves})
        print(f"RD figure written to {path_figure}")
    return (numpy.asarray(eae_rates), numpy.asarray(eae_psnrs))


if __name__ == "__main__":
    main()
