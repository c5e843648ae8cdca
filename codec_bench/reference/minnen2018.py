"""The plain reference that decides the joint-prior cell's ``correct``: a
frozen copy of the port's ``models/minnen2018_plain.py``, so that a later
change to the program cannot move the yardstick. Plain PyTorch in fp32;
it imports nothing of the port, no JAX.

A plain reference of Minnen et al.'s joint autoregressive and
hierarchical prior codec's training step, in fp32.

Minnen, Ballé, Toderici, *Joint Autoregressive and Hierarchical Priors
for Learned Image Compression*, NeurIPS 2018 (arXiv:1809.02736), N = M =
192. Written from the paper's equations alone: it imports only ``torch``
and ``math`` (nothing of the port's kernels or models, no JAX), runs
NCHW tensors through its own TF-SAME convolutions, its own GDN ``x /
sqrt(beta + x^2 gamma^T)`` as an einsum, its context model as a conv of
the kernel times its causal mask, its own entropy models and its own
Adam, with autograd's gradients and both TF32 switches off. No graph, no
kernel, no batching trick: the two sides of every likelihood's intervals
go through their layers one after the other.

It takes the program's parameter dict (``models/minnen2018.py``: conv
kernels OIHW, transposed ones ``(in, out, kh, kw)``, the GDN, context,
entropy-parameter and density variables under the same names) and the
program's noise, drawn in NHWC shapes, ``y``'s first. One noise ``u``
serves ``y`` everywhere: ``y~ = y + u`` feeds the context model, the
rate and the synthesis, as the paper writes it (CompressAI draws a
second noise for the rate).

Departures from the paper, each also made by the program:

- LeakyReLU's slope is 0.01 (CompressAI's; the paper does not state it).

- The GDN's nonnegative reparameterisation, the lower bounds' gradient
  (it passes where the input is at or above the bound or is pushed up)
  and the initial values (``beta = 1``, ``gamma = 0.1 I``, the density at
  the scale 10) are tensorflow-compression's, which the paper used but
  does not spell out.
- The factorized density has no auxiliary loss and no quantile
  parameters: those serve a range coder, and no bitstream is written.
  Evaluation rounds ``z`` and ``y`` themselves.
- One Adam (1e-4, 0.9, 0.999, 1e-8, bias-corrected moments) at a
  constant rate for every parameter; lambda is the caller's.
- The initial conv kernels are N(0, 1 / (in * k * k)) with zero biases
  (the paper states no initialisation); they come from the caller.
"""

import math

import torch
import torch.nn.functional as F

N = 192
M = 192
SLOPE = 0.01
LR = 1e-4
ADAM = (0.9, 0.999, 1e-8)
FILTERS = (3, 3, 3)
SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9
PEDESTAL = (2.0 ** -18) ** 2
BETA_BOUND = math.sqrt(1e-6 + PEDESTAL)
GAMMA_BOUND = 2.0 ** -18


def plain_fp32():
    """True fp32 on the card: TF32 off in both switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class LowerBound(torch.autograd.Function):
    """``max(x, bound)``, whose gradient passes where ``x >= bound`` or
    where it is negative."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.maximum(x, torch.full_like(x, bound))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        keep = torch.logical_or(x >= ctx.bound, grad < 0)
        return (torch.where(keep, grad, torch.zeros_like(grad)), None)


def conv(x, w, stride):
    """TF-SAME conv of NCHW ``x`` with the OIHW kernel ``w``."""
    k = w.shape[-1]
    lo = (k - stride) // 2
    hi = k - stride - lo
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride)


def tconv(x, w, stride):
    """The adjoint of :func:`conv`: ``w`` is ``(in, out, kh, kw)``; the
    full transposed conv cropped to ``stride`` times the input."""
    k = w.shape[-1]
    lo = (k - stride) // 2
    full = F.conv_transpose2d(x, w, stride=stride)
    return full[:, :, lo:lo + stride * x.shape[2], lo:lo + stride * x.shape[3]]


def gdn(x, beta_var, gamma_var, inverse):
    """GDN (IGDN) of NCHW ``x``: ``x_c / sqrt(beta_c + sum_k gamma[c][k]
    x_k^2)`` (times the root), from the stored variables."""
    beta = LowerBound.apply(beta_var, BETA_BOUND) ** 2 - PEDESTAL
    gamma = LowerBound.apply(gamma_var, GAMMA_BOUND) ** 2 - PEDESTAL
    pool = torch.einsum("ck,bkhw->bchw", gamma, x * x) + beta[None, :, None, None]
    return x * torch.sqrt(pool) if inverse else x / torch.sqrt(pool)


def bias(x, b):
    return x + b[None, :, None, None]


def analysis(p, x):
    for i in (1, 2, 3):
        x = gdn(bias(conv(x, p[f"ga_w{i}"], 2), p[f"ga_b{i}"]), p[f"ga_beta{i}"],
                p[f"ga_gamma{i}"], False)
    return bias(conv(x, p["ga_w4"], 2), p["ga_b4"])


def synthesis(p, y):
    x = y
    for i in (1, 2, 3):
        x = gdn(bias(tconv(x, p[f"gs_w{i}"], 2), p[f"gs_b{i}"]), p[f"gs_beta{i}"],
                p[f"gs_gamma{i}"], True)
    return bias(tconv(x, p["gs_w4"], 2), p["gs_b4"])


def leaky(x):
    return torch.where(x > 0, x, SLOPE * x)


def hyper_analysis(p, y):
    z = leaky(bias(conv(y, p["ha_w1"], 1), p["ha_b1"]))
    z = leaky(bias(conv(z, p["ha_w2"], 2), p["ha_b2"]))
    return bias(conv(z, p["ha_w3"], 2), p["ha_b3"])


def hyper_synthesis(p, z):
    """``psi``: the hyper-latents' share of the entropy parameters, 2M maps."""
    s = leaky(bias(tconv(z, p["hs_w1"], 2), p["hs_b1"]))
    s = leaky(bias(tconv(s, p["hs_w2"], 2), p["hs_b2"]))
    return bias(conv(s, p["hs_w3"], 1), p["hs_b3"])


def causal_mask(kernel):
    """1 on the taps strictly before the centre in raster order (the two
    rows above it, the taps left of it in its row), 0 elsewhere."""
    mask = torch.zeros((kernel, kernel))
    for i in range(kernel):
        for j in range(kernel):
            if i < kernel // 2 or (i == kernel // 2 and j < kernel // 2):
                mask[i, j] = 1.0
    return mask


def context_model(p, y_tilde):
    """``phi``: the masked 5x5 conv of ``y~``, 2M maps."""
    w = p["cm_w"]
    mask = causal_mask(w.shape[-1]).to(w.device)
    return bias(conv(y_tilde, w * mask, 1), p["cm_b"])


def entropy_parameters(p, phi, psi):
    """``(sigma, mu)``: three 1x1 convs of ``concat(phi, psi)``, the
    first M maps the scales, the last M the means."""
    e = leaky(bias(conv(torch.cat([phi, psi], dim=1), p["ep_w1"], 1), p["ep_b1"]))
    e = leaky(bias(conv(e, p["ep_w2"], 1), p["ep_b2"]))
    e = bias(conv(e, p["ep_w3"], 1), p["ep_b3"])
    return (e[:, :M], e[:, M:])


def cumulative_logits(p, u):
    """The factorized density's cumulative logits of each channel at the
    points ``u`` ``(C, 1, n)``: four layers over the filters (3, 3, 3)."""
    x = u
    for i in range(len(FILTERS) + 1):
        x = torch.matmul(F.softplus(p[f"fd_matrix_{i}"]), x) + p[f"fd_bias_{i}"]
        if i < len(FILTERS):
            x = x + torch.tanh(p[f"fd_factor_{i}"]) * torch.tanh(x)
    return x


def factorized_likelihood(p, z):
    """``c(z + 1/2) - c(z - 1/2)`` of NCHW ``z`` by the sign trick, at
    least 1e-9, NCHW."""
    u = z.permute(1, 0, 2, 3).reshape(z.shape[1], 1, -1)
    lower = cumulative_logits(p, u - 0.5)
    upper = cumulative_logits(p, u + 0.5)
    sign = -torch.sign(lower + upper).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    likelihood = LowerBound.apply(likelihood, LIKELIHOOD_BOUND)
    (b, c, h, w) = z.shape
    return likelihood.reshape(c, b, h, w).permute(1, 0, 2, 3)


def phi(x):
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def gaussian_likelihood(y, sigma, mu):
    """The Gaussian of mean ``mu`` and scale ``max(sigma, 0.11)``
    integrated over ``y``'s unit bin, at least 1e-9: ``Phi((y - mu + 1/2)
    / sigma) - Phi((y - mu - 1/2) / sigma)``, taken on the lower tail (by
    the symmetry about ``mu``), where the difference keeps its digits."""
    sigma = LowerBound.apply(sigma, SCALE_BOUND)
    d = torch.abs(y - mu)
    likelihood = phi((0.5 - d) / sigma) - phi((-0.5 - d) / sigma)
    return LowerBound.apply(likelihood, LIKELIHOOD_BOUND)


def nchw(t):
    return t.permute(0, 3, 1, 2)


def loss_terms(p, batch_uint8, lmbda, noises=None):
    """``(loss, bpp, mse, reconstruction NCHW)`` of a uint8 NHWC batch:
    with ``noises`` (``y``'s and ``z``'s, NHWC) the training loss, without
    them the latents rounded."""
    x = nchw(batch_uint8.to(torch.float32)) / 255.0
    y = analysis(p, x)
    y_tilde = y + nchw(noises[0]) if noises is not None else torch.round(y)
    z = hyper_analysis(p, y)
    z_tilde = z + nchw(noises[1]) if noises is not None else torch.round(z)
    psi = hyper_synthesis(p, z_tilde)
    (sigma, mu) = entropy_parameters(p, context_model(p, y_tilde), psi)
    bits = (-torch.sum(torch.log2(gaussian_likelihood(y_tilde, sigma, mu)))
            - torch.sum(torch.log2(factorized_likelihood(p, z_tilde))))
    pixels = x.shape[0] * x.shape[2] * x.shape[3]
    bpp = bits / pixels
    x_hat = synthesis(p, y_tilde)
    mse = torch.mean((x - x_hat) ** 2)
    return (bpp + lmbda * 255.0 ** 2 * mse, bpp, mse, x_hat)


def draw_noises(generator, batch, height, width, device):
    """``y``'s noise then ``z``'s, NHWC, U[-1/2, 1/2) from ``generator``."""
    noise_y = torch.rand((batch, height // 16, width // 16, M), generator=generator,
                         device=device) - 0.5
    noise_z = torch.rand((batch, height // 64, width // 64, N), generator=generator,
                         device=device) - 0.5
    return (noise_y, noise_z)


class State:
    """The parameters, Adam's moments and count, and the first step's
    gradient. ``precision`` sets the card's fp32 switches: TF32 off
    (:func:`plain_fp32`) unless a caller asks for less."""

    def __init__(self, params, precision=plain_fp32):
        precision()
        self.params = {name: value.detach().clone() for (name, value) in params.items()}
        self.mu = {name: torch.zeros_like(value) for (name, value) in self.params.items()}
        self.nu = {name: torch.zeros_like(value) for (name, value) in self.params.items()}
        self.count = 0
        self.first_gradient = None

    def gradients(self, batch_uint8, noises, lmbda):
        """``(loss, {name: gradient})`` at the current parameters."""
        leaves = {name: value.detach().requires_grad_(True)
                  for (name, value) in self.params.items()}
        (loss, _, _, _) = loss_terms(leaves, batch_uint8, lmbda, noises)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[name] for name in names])
        return (loss.detach(), dict(zip(names, grads)))

    def step(self, batch_uint8, noises, lmbda):
        """One Adam step on a uint8 NHWC batch; returns the loss."""
        (loss, grads) = self.gradients(batch_uint8, noises, lmbda)
        if self.first_gradient is None:
            self.first_gradient = grads
        (b1, b2, eps) = ADAM
        self.count += 1
        with torch.no_grad():
            for (name, grad) in grads.items():
                self.mu[name] = b1 * self.mu[name] + (1 - b1) * grad
                self.nu[name] = b2 * self.nu[name] + (1 - b2) * grad * grad
                update = (self.mu[name] / (1 - b1 ** self.count)) / (
                    torch.sqrt(self.nu[name] / (1 - b2 ** self.count)) + eps)
                self.params[name] = self.params[name] - LR * update
        return loss


@torch.no_grad()
def evaluate(params, batch_uint8, lmbda):
    """``{"bpp", "mse", "psnr", "loss"}`` with the latents rounded, PSNR of
    the reconstruction clipped to [0, 1], in true fp32."""
    plain_fp32()
    (loss, bpp, mse, x_hat) = loss_terms(params, batch_uint8, lmbda)
    x = nchw(batch_uint8.to(torch.float32)) / 255.0
    psnr = -10.0 * torch.log10(torch.mean((x - torch.clamp(x_hat, 0.0, 1.0)) ** 2))
    return {"bpp": bpp, "mse": mse, "psnr": psnr, "loss": loss}
