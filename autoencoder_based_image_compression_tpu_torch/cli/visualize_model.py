"""Model-inspection figures from a trained checkpoint.

Counterpart of the reference's ``checking_*`` hooks
(``EntropyAutoencoder.py:591-745``) and of the reference package's
``cli/visualize_model.py``: normed histograms of the noisy latents
overlaid with the fitted pdfs (``checking_activations_1``), latent-map
mosaics (``checking_activations_2``), first and last conv-filter mosaics
(``checking_p_2``), GDN weight images (``checking_p_3``) and the
histogram of the areas under the piecewise-linear pdfs
(``checking_area_under_piecewise_linear_functions``), plus ``--device
cuda|cpu``.

:func:`model_arrays` computes everything the figures show, on the
device (the encoder goes through the GDN kernels on the card), and
returns numpy arrays; :func:`draw` writes the figures on the host with
matplotlib and PIL.
"""

import argparse
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.quantization import add_uniform_noise
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_checkpoint,
    params_to_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_positive,
)

GDN_SITES = (1, 2, 5, 6)


@torch.no_grad()
def model_arrays(state, images_uint8, learn_bin_widths, nb_maps_histograms, noise):
    """What the figures draw, as numpy arrays: the latents ``y`` of the
    images and their noisy version ``y_tilde`` (the trained bin widths,
    ``noise`` a generator on the state's device or the U[-0.5, 0.5)
    draw), the table's ``grid`` and the first ``nb_maps_histograms``
    ``pdfs``, the first and last conv kernels in HWIO, the GDN weight
    images (uint8) and the ``areas`` under the live pdfs."""
    device = state.step.device
    if images_uint8.ndim == 3:
        images_uint8 = images_uint8[..., None]
    batch = torch.from_numpy(images_uint8.astype(numpy.float32)).to(device)
    y = conv_eae.encode(state.params, batch, learn_bin_widths)
    y_tilde = add_uniform_noise(noise, y, state.bin_widths)
    kernels = params_to_jax({name: state.params[name] for name in ("weights_1", "weights_6")})
    gdn_images = {}
    for i in GDN_SITES:
        gamma = state.params[f"gamma_{i}"].cpu().numpy()
        (lo, hi) = (gamma.min(), gamma.max())
        gdn_images[i] = numpy.round(255.0 * (gamma - lo) / (hi - lo)).astype(numpy.uint8)
    areas = dens.area_under_piecewise_linear_functions(
        state.density.parameters, state.density.nb_itvs_per_side,
        csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE)
    return {
        "y": y.cpu().numpy(), "y_tilde": y_tilde.cpu().numpy(),
        "grid": dens.table_grid(csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE),
        "pdfs": state.density.parameters[:nb_maps_histograms].cpu().numpy(),
        "weights_encoder": kernels["weights_1"], "weights_decoder": kernels["weights_6"],
        "gdn_images": gdn_images, "areas": areas.cpu().numpy(),
    }


def draw(arrays, out_dir):
    """Writes the figures of :func:`model_arrays`' arrays under ``out_dir``."""
    from autoencoder_based_image_compression_tpu_torch.eval import visualization as viz
    from autoencoder_based_image_compression_tpu_torch.utils.image import save_image

    nb = arrays["pdfs"].shape[0]
    viz.normed_histogram(
        arrays["y_tilde"][..., :nb], arrays["grid"], arrays["pdfs"],
        [f"noisy latent map {i}" for i in range(nb)],
        [os.path.join(out_dir, f"histogram_map_{i}.png") for i in range(nb)])
    for (i, latents) in enumerate(arrays["y"]):
        viz.visualize_representation(latents, 8, os.path.join(out_dir, f"latents_{i}.png"))
    viz.visualize_weights(arrays["weights_encoder"], 8,
                          os.path.join(out_dir, "weights_encoder.png"))
    viz.visualize_weights(arrays["weights_decoder"], 8,
                          os.path.join(out_dir, "weights_decoder.png"))
    for (i, image) in arrays["gdn_images"].items():
        save_image(os.path.join(out_dir, f"gdn_gamma_{i}.png"), image)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.hist(arrays["areas"], bins=30)
    plt.title("areas under the piecewise-linear pdfs")
    plt.savefig(os.path.join(out_dir, "pdf_areas.png"))
    plt.clf()


def main(args=None):
    parser = argparse.ArgumentParser(description="Model visualization artifacts.")
    parser.add_argument("bin_width_init", type=float_strictly_positive)
    parser.add_argument("gamma", type=float_strictly_positive)
    parser.add_argument("idx_training", type=int_positive)
    parser.add_argument("--learn_bin_widths", action="store_true")
    parser.add_argument("--path_to_images", default="data/kodak/kodak.npy")
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--out_dir", default="results/visualization")
    parser.add_argument("--nb_maps_histograms", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)

    template = init_train_state(torch.Generator().manual_seed(0), args.bin_width_init,
                                args.learn_bin_widths, device=args.device)
    exp_dir = os.path.join(args.results_root,
                           experiment_suffix(args.bin_width_init, args.gamma,
                                             args.learn_bin_widths))
    state = load_checkpoint(os.path.join(exp_dir, f"model_{args.idx_training}"), template)
    os.makedirs(args.out_dir, exist_ok=True)
    images = numpy.load(args.path_to_images)[:2]
    arrays = model_arrays(state, images, args.learn_bin_widths, args.nb_maps_histograms,
                          torch.Generator(state.step.device).manual_seed(1))
    draw(arrays, args.out_dir)
    print(f"visualization artifacts written to {args.out_dir}")


if __name__ == "__main__":
    main()
