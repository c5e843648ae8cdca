"""Overfit sanity harness for the dense SVHN entropy autoencoder.

Counterpart of ``svhn/overfitting_eae_svhn.py`` and of the reference
package's ``cli/overfit_svhn.py``: trains on a handful of digits and
prints the objective's trajectory, a fast check that the alternating
optimisation drives the rate-distortion objective down. One ``eps`` a
step serves both phases; the evaluation noise is the same draw every
time, as the reference's fixed evaluation key. The digits are one batch:
the pre-fit is one ``fit_epoch`` of its steps over that batch, and each
epoch one ``train_epoch`` of one batch (on the card, one replay of a
captured step).
"""

import argparse

import torch

from autoencoder_based_image_compression_tpu_torch.data.svhn import (
    compute_preprocessing_stats,
    preprocess_svhn,
    synthetic_svhn,
)
from autoencoder_based_image_compression_tpu_torch.models import dense_eae
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import rows_in_order
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.parsing import (
    float_strictly_positive,
    int_strictly_positive,
)

NB_FITTING_STEPS = 20


def main(args=None):
    parser = argparse.ArgumentParser(description="Overfit harness (SVHN EAE).")
    parser.add_argument("--gamma", type=float_strictly_positive, default=1.0)
    parser.add_argument("--nb_examples", type=int_strictly_positive, default=10)
    parser.add_argument("--nb_epochs", type=int_strictly_positive, default=400)
    parser.add_argument("--learn_bin_width", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    digits_uint8 = synthetic_svhn(args.nb_examples, seed=args.seed)
    (mean_training, std_training) = compute_preprocessing_stats(digits_uint8)
    digits = torch.from_numpy(preprocess_svhn(digits_uint8, mean_training,
                                              std_training)).to(device)

    state = dense_eae.init_dense_eae_state(torch.Generator().manual_seed(args.seed),
                                           device=device)
    fns = dense_eae.make_dense_step_fns(args.gamma, args.learn_bin_width)
    noise = torch.Generator(device).manual_seed(args.seed + 1)
    latent_shape = (digits.shape[0], state.params["we_latent"].shape[1])
    eps_eval = dense_eae.uniform_eps(torch.Generator(device).manual_seed(args.seed + 2),
                                     latent_shape, device)

    batch = rows_in_order(1, digits.shape[0])
    objectives = []
    state = fns["fit_epoch"](state, digits, batch.expand(NB_FITTING_STEPS, -1), noise)
    for epoch in range(args.nb_epochs):
        state = fns["train_epoch"](state, digits, batch, noise)
        if epoch % 50 == 0 or epoch == args.nb_epochs - 1:
            (_, scaled_h, rec, _, _) = fns["evaluation"](state, digits, eps_eval)
            objectives.append(float(scaled_h) + float(rec))
            print(f"epoch {epoch}: objective {objectives[-1]:.4f} "
                  f"(rec {float(rec):.4f}, scaled-H {float(scaled_h):.4f}) "
                  f"bw {float(state.bin_width):.3f}")
    print("overfit harness done - the objective above should be decreasing")
    return objectives


if __name__ == "__main__":
    main()
