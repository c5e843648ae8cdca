"""Entropy-approximation error study.

Counterpart of ``svhn/comparing_approximations_entropy.py:16-110`` and of
the reference package's ``cli/compare_entropy_approximations.py``: for
samples from known distributions (Gaussian, Laplace) and a range of
quantisation bin widths, compares

- the *theoretical* approximation ``H(Q(X)) ~ h(X) - log2(delta)``,
- the *fitted-pdf* approximation (differential entropy of the noisy
  samples under the trained piecewise-linear density minus
  ``log2(delta)``),

against the empirical discrete entropy of the quantised samples. Prints
one table per distribution. The samples and the noise come from numpy's
``default_rng`` on the host, as in the reference package; the density is
fitted on the device by plain SGD with the same table geometry, the 400
steps of a fit the replays of one captured step on the card (the
counterpart of the reference package's jitted step).
"""

import argparse

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.metrics import discrete_entropy
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

PPI = 4
MAX_ITVS = 32


def _fit_step(table, rows, noise):
    """One SGD step of the density fit and its projection, on the table's
    live cells; ``rows`` is the ``(1, n)`` noisy samples, ``noise`` unused
    (the step draws nothing)."""
    mask = dens.active_mask(table.nb_itvs_per_side, PPI, MAX_ITVS)
    leaf = table.parameters.detach().requires_grad_(True)
    with torch.enable_grad():
        prob = dens.approximate_probability(rows, leaf, PPI, MAX_ITVS)
        loss = dens.loss_density_approximation(prob, leaf, mask, PPI)
    (grads,) = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        parameters = dens.project_density_parameters(table.parameters - csts.LR_FCT * grads,
                                                     mask)
    return table._replace(parameters=parameters)


def fit_density(samples_noisy, nb_steps=400, fit_epoch=None):
    """Fits the piecewise-linear pdf to the noisy samples (a 1-D tensor)
    by SGD on their device; returns the ``(1, W)`` parameters. The grid is
    grown once to hold the samples; each of the ``nb_steps`` steps takes
    the same samples (row 0 of a one-row set). ``fit_epoch`` is the
    ``epoch_fn`` of :func:`_fit_step` that runs them: the replays of one
    captured step on the card, the eager loop on the CPU; fits that share
    one share its capture for a sample count (a new one by default)."""
    fit_epoch = fit_epoch or epoch_fn(_fit_step)
    table = dens.init_density_table(1, PPI, MAX_ITVS, device=samples_noisy.device)
    max_abs = torch.max(torch.abs(samples_noisy)) + 0.5
    table = dens.expand_table(table, max_abs, PPI, MAX_ITVS)
    rows = torch.zeros((nb_steps, 1), dtype=torch.int64)
    return fit_epoch(table, samples_noisy[None, :], rows, None).parameters


def theoretical_differential_entropy(name, scale):
    if name == "gaussian":
        return 0.5 * numpy.log2(2.0 * numpy.pi * numpy.e * scale ** 2)
    if name == "laplace":
        return numpy.log2(2.0 * numpy.e * scale)
    raise ValueError(name)


def main(args=None):
    parser = argparse.ArgumentParser(description="Entropy approximation study.")
    parser.add_argument("--nb_samples", type=int, default=200000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(args)
    device = resolve_device(args.device)

    rng = numpy.random.default_rng(args.seed)
    bin_widths = [0.25, 0.5, 1.0, 2.0]
    fit_epoch = epoch_fn(_fit_step)  # the 8 fits share one capture
    table = {}
    for (name, scale, sampler) in [
            ("gaussian", 2.0, lambda n: rng.normal(0.0, 2.0, n)),
            ("laplace", 1.5, lambda n: rng.laplace(0.0, 1.5, n))]:
        samples = sampler(args.nb_samples).astype(numpy.float32)
        h_x = theoretical_differential_entropy(name, scale)
        print(f"\n{name} (scale {scale}): h(X) = {h_x:.4f} bits")
        print("  delta   H(Q(X))   h(X)-log2(d)   fitted-log2(d)")
        for delta in bin_widths:
            quantized = delta * numpy.round(samples / delta)
            empirical = discrete_entropy(quantized, delta)
            theory = h_x - numpy.log2(delta)
            noise = rng.uniform(-0.5 * delta, 0.5 * delta,
                                args.nb_samples).astype(numpy.float32)
            noisy = torch.from_numpy(samples + noise).to(device)
            parameters = fit_density(noisy, fit_epoch=fit_epoch)
            with torch.no_grad():
                prob = dens.approximate_probability(noisy[None, :], parameters, PPI, MAX_ITVS)
                fitted = float(dens.differential_entropy(prob)[0]) - numpy.log2(delta)
            table[(name, delta)] = (empirical, theory, fitted)
            print(f"  {delta:5.2f}   {empirical:7.4f}   {theory:12.4f}   {fitted:14.4f}")
    return table


if __name__ == "__main__":
    main()
