"""Piecewise-linear latent density model with a fixed-capacity table.

The reference codec fits, per latent feature map, a piecewise-linear pdf
sampled on a symmetric grid, and grows the grid at run time whenever a
latent overflows it (``kodak_tensorflow/tfutils/tfutils.py:95-153``
``approximate_probability``, ``:223-299`` ``expand_all``). Here, as in
the JAX package's ``ops/density.py``, the table is allocated once for
``max_itvs_per_side`` unit intervals per side, the live half-width is a
scalar tensor on the device, and the cells outside the live extent are
pinned at ``LOW_PROJECTION``. Growing the grid then moves that scalar
(the newly live cells already hold the value the reference pads with),
so a training step never waits for the host to learn a new shape.

Every function also takes a leading model axis (the gamma ladder): ``(M,
nb_maps, W)`` tables, ``(M,)`` extents, ``(M, nb_maps, n)`` samples and
``(M, W)`` masks; gathers and reductions run over the last axis, and what
a single model gets is unchanged.

Table geometry: ``W = 2 * ppi * max_itvs + 1`` sampling points; the cell
at index ``i`` sits at grid position ``(i - C) / ppi`` with the centre
``C = ppi * max_itvs``. A sample ``x`` falls into the linear piece whose
left cell is ``floor(ppi * x) + C``.
"""

import math
from typing import NamedTuple

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts


class DensityTable(NamedTuple):
    """State of the density model.

    ``parameters``: ``(nb_maps, W)`` float32, the per-map pdf samples;
    cells outside the live extent hold ``LOW_PROJECTION``.
    ``nb_itvs_per_side``: int32 scalar tensor, the live number of unit
    intervals per side.
    """

    parameters: torch.Tensor
    nb_itvs_per_side: torch.Tensor


def table_width(ppi, max_itvs):
    """Number of sampling points of the fixed-capacity table."""
    return 2 * ppi * max_itvs + 1


def table_grid(ppi, max_itvs):
    """Sampling-point positions (numpy): ``grid[i] = (i - C) / ppi``."""
    width = table_width(ppi, max_itvs)
    return (numpy.arange(width, dtype=numpy.float32) - ppi * max_itvs) / ppi


def _cell_offsets(nb_itvs_per_side, ppi, max_itvs):
    """``|i - C|`` for every cell, on the device of the live extent."""
    width = table_width(ppi, max_itvs)
    cells = torch.arange(width, dtype=torch.int32, device=nb_itvs_per_side.device)
    return torch.abs(cells - ppi * max_itvs)


def active_mask(nb_itvs_per_side, ppi, max_itvs, dtype=torch.float32):
    """1.0 on the live cells ``|i - C| <= ppi * nb_itvs``, 0.0 outside:
    ``(W,)`` for a scalar extent, ``(M, W)`` for ``(M,)`` extents."""
    nb_itvs_per_side = torch.as_tensor(nb_itvs_per_side)
    offsets = _cell_offsets(nb_itvs_per_side, ppi, max_itvs)
    return (offsets <= ppi * nb_itvs_per_side[..., None]).to(dtype)


def init_density_table(nb_maps, ppi=csts.NB_POINTS_PER_INTERVAL,
                       max_itvs=csts.MAX_ITVS_PER_SIDE,
                       nb_itvs_init=csts.NB_ITVS_PER_SIDE_INIT, device="cpu"):
    """Cauchy pdf on the live cells, the floor outside (reference
    ``EntropyAutoencoder.py:126-129``, ``tools/tools.py:1134``)."""
    grid = table_grid(ppi, max_itvs)
    pdf = torch.from_numpy((1.0 / (numpy.pi * (1.0 + grid ** 2))).astype(numpy.float32))
    nb_itvs = torch.tensor(nb_itvs_init, dtype=torch.int32)
    mask = active_mask(nb_itvs, ppi, max_itvs)
    parameters = torch.where(mask > 0, pdf, csts.LOW_PROJECTION)
    parameters = parameters.repeat(nb_maps, 1)
    return DensityTable(parameters=parameters.to(device),
                        nb_itvs_per_side=nb_itvs.to(device))


def index_linear_piece(samples, ppi, max_itvs):
    """Left-cell index (int64) of the linear piece holding each sample,
    clipped into the table: expansion keeps live samples inside, the
    clip guards an overflow of the capacity."""
    idx = torch.floor(ppi * samples).to(torch.int64) + ppi * max_itvs
    return torch.clamp(idx, 0, table_width(ppi, max_itvs) - 2)


def approximate_probability(samples, parameters, ppi, max_itvs):
    """Linear interpolation of each per-map pdf at the sample positions.

    ``samples``: ``(nb_maps, n)``, row i holds the samples of the ith
    pdf; ``parameters``: ``(nb_maps, W)`` (each with a leading model
    axis for M models). Reference
    ``tfutils.py:95-153``. The gradient with respect to ``parameters``
    is a scatter-add, which runs with atomics on the card: it is not
    bitwise repeatable there.
    """
    idx = index_linear_piece(samples, ppi, max_itvs)
    left = torch.gather(parameters, -1, idx)
    right = torch.gather(parameters, -1, idx + 1)
    left_bound = torch.floor(ppi * samples) / ppi
    return (right - left) * (samples - left_bound) * ppi + left


def differential_entropy(approximate_prob):
    """Per-map differential entropy estimate, ``mean(-log2 p)`` per row
    (reference ``tfutils.py:198-221``)."""
    return torch.mean(-torch.log(approximate_prob) / math.log(2.0), dim=-1)


def approximate_entropy_per_map(approximate_prob, bin_widths):
    """Per-map approximate entropy, UNCLAMPED: the differential entropy
    of the noisy latents minus ``log2(bin_width)`` (reference
    ``tfutils.py:45-93``). The reference asserts non-negativity; here
    negative values come back as they are, for the training monitor."""
    diff_entropies = differential_entropy(approximate_prob)
    return diff_entropies - torch.log(bin_widths) / math.log(2.0)


def approximate_entropy(approximate_prob, bin_widths):
    """Cumulated approximate entropy of the quantised latents: the sum
    over maps of the per-map entropies, clamped at 0 (one a model)."""
    approx = approximate_entropy_per_map(approximate_prob, bin_widths)
    return torch.sum(torch.clamp_min(approx, 0.0), dim=-1)


def loss_density_approximation(approximate_prob, parameters, mask, ppi):
    """Fitting loss of the piecewise-linear pdfs (a MISE surrogate):
    ``sum_i (-2 * mean_j p_ij + sum_k (mask_k * params_ik)^2 / ppi)``
    (reference ``tfutils.py:511-552``), one a model. The mask keeps the
    quadratic term on the live cells."""
    mean_prob = torch.mean(approximate_prob, dim=-1)
    sum_sq = torch.sum(torch.square(parameters * mask[..., None, :]), dim=-1)
    return torch.sum(-2.0 * mean_prob + sum_sq / ppi, dim=-1)


def area_under_piecewise_linear_functions(parameters, nb_itvs_per_side, ppi, max_itvs):
    """Trapezoidal area under each live pdf (training diagnostic;
    reference ``tfutils.py:155-196``): a masked weighted sum with
    half-weight end points."""
    nb_itvs_per_side = torch.as_tensor(nb_itvs_per_side, device=parameters.device)
    offsets = _cell_offsets(nb_itvs_per_side, ppi, max_itvs)
    extent = ppi * nb_itvs_per_side[..., None]
    weights = torch.where(offsets == extent, 0.5, 1.0) * (offsets <= extent)
    return torch.sum(parameters * weights[..., None, :], dim=-1) / ppi


def expand_table(table, max_abs, ppi, max_itvs):
    """Grows the live extent when ``max_abs`` reaches its boundary.

    ``max_abs`` (a scalar tensor, or one a model) is the largest absolute
    latent plus half the largest bin width. When ``max_abs >= nb_itvs`` the extent
    becomes ``ceil(max_abs) + 1`` intervals per side (reference
    ``tfutils.py:223-299``), at most the capacity ``max_itvs``. Only
    the scalar moves, on the device.
    """
    nb_itvs = table.nb_itvs_per_side
    is_expansion = max_abs >= nb_itvs.to(max_abs.dtype)
    grown = torch.ceil(max_abs).to(torch.int32) + 1
    new_nb = torch.where(is_expansion, torch.maximum(grown, nb_itvs), nb_itvs)
    return table._replace(nb_itvs_per_side=torch.clamp(new_nb, max=max_itvs))


def project_density_parameters(parameters, mask):
    """Clamps live cells to ``>= LOW_PROJECTION`` and pins dead cells at
    it again (reference projection ``EntropyAutoencoder.py:290-293``)."""
    return torch.where(mask[..., None, :] > 0,
                       torch.clamp_min(parameters, csts.LOW_PROJECTION), csts.LOW_PROJECTION)
