"""One model's training step, plain PyTorch in fp32.

The reference's alternation (``kodak_tensorflow/eae/batching.py``,
``EntropyAutoencoder.py``), one batch:

1. Density phase. Encode without grad, add uniform noise ``bw * u``,
   ``u ~ U[-0.5, 0.5)``. Grow the table's live half-width to
   ``ceil(max|y| + max(bw) / 2) + 1`` unit intervals when the latents
   reach it (at most the capacity). One SGD step (rate 0.2) on the
   piecewise-linear pdfs' fitting loss ``sum_maps (-2 mean(p) +
   sum((mask * P)^2) / ppi)``, then every live cell floored at 1e-6 and
   every dead cell pinned there.
2. Autoencoder phase, on fresh noise and the updated pdfs: the loss
   ``mean_batch sum_pixels (x - x_hat)^2 + gamma * sum_maps max(0,
   mean(-log2 p) - log2 bw) + 5e-4 * sum_convs |w|^2 / 2``; one Adam step
   (rate 1e-4, 0.9, 0.999, 1e-8, bias-corrected) on the transforms; with
   learned bin widths one SGD step (rate 2e-8) on them, clipped to [0.8,
   4]; then every GDN beta and gamma floored at 2e-5 and each gamma made
   symmetric.

The table has ``ppi = 5`` samples a unit interval over 64 intervals a
side (641 cells, 10 intervals live at the start, a Cauchy pdf on them).
Noise is drawn from a generator, the density phase first, so that a
generator seeded as the program's draws the same numbers.
"""

import math

import torch

from codec_bench.reference import codec

PPI = 5
MAX_ITVS = 64
WIDTH = 2 * PPI * MAX_ITVS + 1
CENTRE = PPI * MAX_ITVS
NB_ITVS_INIT = 10
FLOOR = 1e-6
LR_DENSITY = 0.2
LR_ADAM = 1e-4
LR_BIN_WIDTHS = 2e-8
WEIGHT_DECAY = 5e-4
MIN_GDN = 2e-5
BIN_WIDTH_RANGE = (0.8, 4.0)
ADAM = (0.9, 0.999, 1e-8)
CONVS = ("weights_1", "weights_2", "weights_3", "weights_4", "weights_5", "weights_6")


def initial_table(nb_maps, device):
    """``(table, live intervals a side)``: the Cauchy pdf on the live cells."""
    cells = torch.arange(WIDTH, dtype=torch.float64) - CENTRE
    grid = cells / PPI
    pdf = 1.0 / (math.pi * (1.0 + grid ** 2))
    table = torch.where(cells.abs() <= PPI * NB_ITVS_INIT, pdf, FLOOR).to(torch.float32)
    return (table.repeat(nb_maps, 1).to(device), NB_ITVS_INIT)


def live_mask(nb_itvs, device):
    cells = torch.arange(WIDTH, device=device) - CENTRE
    return (cells.abs() <= PPI * nb_itvs).to(torch.float32)


def probability(samples, table):
    """The pdfs ``table`` (maps, W) linearly interpolated at ``samples``
    (maps, n)."""
    left_cell = torch.floor(PPI * samples)
    index = (left_cell.to(torch.int64) + CENTRE).clamp(0, WIDTH - 2)
    left = torch.gather(table, 1, index)
    right = torch.gather(table, 1, index + 1)
    return left + (right - left) * (samples - left_cell / PPI) * PPI


def _maps(y_nchw):
    """(B, C, h, w) -> (C, B*h*w), the samples of each map."""
    return y_nchw.permute(1, 0, 2, 3).reshape(y_nchw.shape[1], -1)


def _noise(noise_nhwc):
    return noise_nhwc.permute(0, 3, 1, 2)


def density_phase(params, table, nb_itvs, bin_widths, x, noise_nhwc):
    """Step 1: ``(new table, new live intervals)``."""
    with torch.no_grad():
        y = codec.encode(params, x)
        y_tilde = y + bin_widths[None, :, None, None] * _noise(noise_nhwc)
        reach = float(y.abs().max() + 0.5 * bin_widths.max())
        if reach >= nb_itvs:
            nb_itvs = min(max(math.ceil(reach) + 1, nb_itvs), MAX_ITVS)
    mask = live_mask(nb_itvs, table.device)
    pdfs = table.detach().clone().requires_grad_(True)
    prob = probability(_maps(y_tilde), pdfs)
    loss = torch.sum(-2.0 * prob.mean(dim=1) + torch.sum((pdfs * mask) ** 2, dim=1) / PPI)
    (grad,) = torch.autograd.grad(loss, pdfs)
    with torch.no_grad():
        new = torch.where(mask > 0, torch.clamp_min(table - LR_DENSITY * grad, FLOOR), FLOOR)
    return (new, nb_itvs)


def rd_loss(params, bin_widths, x, noise_nhwc, table, gamma):
    y = codec.encode(params, x)
    y_tilde = y + bin_widths[None, :, None, None] * _noise(noise_nhwc)
    prob = probability(_maps(y_tilde), table)
    entropy = torch.clamp_min(torch.mean(-torch.log2(prob), dim=1) - torch.log2(bin_widths), 0.0)
    reconstruction = codec.decode(params, y_tilde)
    distortion = torch.mean(torch.sum((x - reconstruction) ** 2, dim=(1, 2, 3)))
    decay = WEIGHT_DECAY * sum(0.5 * torch.sum(params[name] ** 2) for name in CONVS)
    return distortion + gamma * entropy.sum() + decay


class State:
    """One model's training state in the reference's terms: conv kernels
    in ``conv2d`` / ``conv_transpose2d`` layouts (the benchmark's own
    initial weights), the pdf table, the bin widths and Adam's moments."""

    def __init__(self, params, bin_width, learn_bin_widths):
        device = params["weights_1"].device
        self.params = {name: value.detach().clone() for (name, value) in params.items()}
        (self.table, self.nb_itvs) = initial_table(codec_maps(params), device)
        self.bin_widths = torch.full((codec_maps(params),), float(bin_width),
                                     dtype=torch.float32, device=device)
        self.learn_bin_widths = learn_bin_widths
        self.mu = {name: torch.zeros_like(value) for (name, value) in self.params.items()}
        self.nu = {name: torch.zeros_like(value) for (name, value) in self.params.items()}
        self.count = 0
        (self.first_gradient, self.first_table) = (None, None)

    def step(self, batch_uint8_nhwc, noises, gamma):
        """One alternation on a ``(B, H, W, 1)`` uint8 batch; ``noises`` the
        density phase's and the autoencoder phase's uniform noise, NHWC."""
        x = batch_uint8_nhwc.permute(0, 3, 1, 2).to(torch.float32)
        (self.table, self.nb_itvs) = density_phase(self.params, self.table, self.nb_itvs,
                                                   self.bin_widths, x, noises[0])
        leaves = {name: value.detach().requires_grad_(True)
                  for (name, value) in self.params.items()}
        bin_widths = self.bin_widths.detach().requires_grad_(self.learn_bin_widths)
        loss = rd_loss(leaves, bin_widths, x, noises[1], self.table, gamma)
        names = list(leaves)
        inputs = [leaves[name] for name in names] + ([bin_widths] if self.learn_bin_widths
                                                     else [])
        grads = torch.autograd.grad(loss, inputs)
        if self.first_gradient is None:
            (self.first_gradient, self.first_table) = (dict(zip(names, grads)), self.table)
        with torch.no_grad():
            (b1, b2, eps) = ADAM
            self.count += 1
            for (name, grad) in zip(names, grads):
                self.mu[name] = b1 * self.mu[name] + (1 - b1) * grad
                self.nu[name] = b2 * self.nu[name] + (1 - b2) * grad * grad
                update = (self.mu[name] / (1 - b1 ** self.count)) / (
                    torch.sqrt(self.nu[name] / (1 - b2 ** self.count)) + eps)
                self.params[name] = self.params[name] - LR_ADAM * update
            if self.learn_bin_widths:
                self.bin_widths = (self.bin_widths - LR_BIN_WIDTHS * grads[-1]).clamp(
                    *BIN_WIDTH_RANGE)
            for name in list(self.params):
                if name.startswith(("beta_", "gamma_")):
                    self.params[name] = torch.clamp_min(self.params[name], MIN_GDN)
                if name.startswith("gamma_"):
                    self.params[name] = 0.5 * (self.params[name] + self.params[name].t())
        return loss.detach()


def codec_maps(params):
    return params["biases_1"].shape[0]
