"""PyTorch port: the piecewise-linear density model against the JAX
package's ``ops/density.py`` on the same seeded numpy inputs, both on
the CPU in float32.

Tolerances: both sides do the same float32 arithmetic on the same
operands; only reductions (means and sums over up to a few thousand
terms) may be taken in another order, hence rtol 1e-5 on losses and
entropies, and exact equality wherever no reduction is involved.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu import constants as jcsts
from autoencoder_based_image_compression_tpu.ops import density as jd
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.ops import density as td

PPI = 5
MAX_ITVS = 32
NB_MAPS = 6


def _t(array):
    return torch.from_numpy(numpy.asarray(array))


def _case(seed, nb_samples=400, scale=3.0):
    """Samples (NB_MAPS, n) inside the initial grid, a perturbed table,
    bin widths."""
    rng = numpy.random.default_rng(seed)
    samples = (scale * rng.standard_normal((NB_MAPS, nb_samples))).astype(numpy.float32)
    samples = samples.clip(-9.5, 9.5)
    table = jd.init_density_table(NB_MAPS, PPI, MAX_ITVS, 10)
    parameters = numpy.asarray(table.parameters) * rng.uniform(
        0.5, 1.5, size=table.parameters.shape).astype(numpy.float32)
    bin_widths = rng.uniform(0.8, 2.0, NB_MAPS).astype(numpy.float32)
    return (samples, parameters.astype(numpy.float32), bin_widths)


def test_constants_match():
    for name in ("LR_EAE", "LR_FCT", "LR_BW", "WEIGHT_DECAY_P", "MIN_GAMMA_BETA", "MIN_BW",
                 "MAX_BW", "NB_ITVS_PER_SIDE_INIT", "NB_POINTS_PER_INTERVAL",
                 "LOW_PROJECTION", "MAX_ITVS_PER_SIDE"):
        assert getattr(csts, name) == getattr(jcsts, name), name
    for gamma in (1.0, 10000.0, 59999.0, 60000.0, 79999.0, 80000.0, 1.0e6):
        assert csts.lr_boundaries(gamma) == jcsts.lr_boundaries(gamma)


def test_table_geometry_and_init():
    assert td.table_width(PPI, MAX_ITVS) == jd.table_width(PPI, MAX_ITVS) == 321
    numpy.testing.assert_array_equal(td.table_grid(PPI, MAX_ITVS), jd.table_grid(PPI, MAX_ITVS))
    got = td.init_density_table(NB_MAPS, PPI, MAX_ITVS, 10)
    expected = jd.init_density_table(NB_MAPS, PPI, MAX_ITVS, 10)
    assert got.parameters.dtype == torch.float32
    assert got.nb_itvs_per_side.dtype == torch.int32 and got.nb_itvs_per_side.dim() == 0
    numpy.testing.assert_array_equal(got.parameters.numpy(), numpy.asarray(expected.parameters))
    assert int(got.nb_itvs_per_side) == int(expected.nb_itvs_per_side) == 10
    # The default capacity is the reference's.
    assert td.init_density_table(2).parameters.shape == (2, 2 * 5 * 64 + 1)


@pytest.mark.parametrize("nb_itvs", [0, 1, 10, 31, 32])
def test_active_mask(nb_itvs):
    got = td.active_mask(torch.tensor(nb_itvs, dtype=torch.int32), PPI, MAX_ITVS)
    expected = jd.active_mask(jnp.asarray(nb_itvs, jnp.int32), PPI, MAX_ITVS)
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(expected))
    assert int(got.sum()) == 2 * PPI * nb_itvs + 1


def test_index_linear_piece_also_at_borders_and_overflow():
    rng = numpy.random.default_rng(0)
    samples = numpy.concatenate([
        (4.0 * rng.standard_normal(200)).astype(numpy.float32),
        numpy.arange(-10, 11, dtype=numpy.float32) / PPI,       # on cell borders
        numpy.array([-1e4, 1e4, 31.999, 32.0, -32.0, -32.001], numpy.float32),
    ])[None, :]
    got = td.index_linear_piece(_t(samples), PPI, MAX_ITVS)
    expected = jd.index_linear_piece(jnp.asarray(samples), PPI, MAX_ITVS)
    assert got.dtype == torch.int64
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(expected))
    assert got.min() >= 0 and got.max() <= td.table_width(PPI, MAX_ITVS) - 2


@pytest.mark.parametrize("seed", [0, 1])
def test_probability_entropies_loss_and_area(seed):
    (samples, parameters, bin_widths) = _case(seed)
    prob_j = jd.approximate_probability(jnp.asarray(samples), jnp.asarray(parameters), PPI,
                                        MAX_ITVS)
    prob_t = td.approximate_probability(_t(samples), _t(parameters), PPI, MAX_ITVS)
    # Same gathers, same float32 expression: no reduction involved.
    numpy.testing.assert_allclose(prob_t.numpy(), numpy.asarray(prob_j), rtol=1e-6, atol=0)

    numpy.testing.assert_allclose(td.differential_entropy(prob_t).numpy(),
                                  numpy.asarray(jd.differential_entropy(prob_j)), rtol=1e-5)
    per_map_t = td.approximate_entropy_per_map(prob_t, _t(bin_widths))
    per_map_j = jd.approximate_entropy_per_map(prob_j, jnp.asarray(bin_widths))
    numpy.testing.assert_allclose(per_map_t.numpy(), numpy.asarray(per_map_j), rtol=1e-5,
                                  atol=1e-6)
    numpy.testing.assert_allclose(
        float(td.approximate_entropy(prob_t, _t(bin_widths))),
        float(jd.approximate_entropy(prob_j, jnp.asarray(bin_widths))), rtol=1e-5)

    nb_itvs = 10
    mask_t = td.active_mask(torch.tensor(nb_itvs, dtype=torch.int32), PPI, MAX_ITVS)
    mask_j = jd.active_mask(jnp.asarray(nb_itvs, jnp.int32), PPI, MAX_ITVS)
    numpy.testing.assert_allclose(
        float(td.loss_density_approximation(prob_t, _t(parameters), mask_t, PPI)),
        float(jd.loss_density_approximation(prob_j, jnp.asarray(parameters), mask_j, PPI)),
        rtol=1e-5)
    areas_t = td.area_under_piecewise_linear_functions(
        _t(parameters), torch.tensor(nb_itvs, dtype=torch.int32), PPI, MAX_ITVS)
    areas_j = jd.area_under_piecewise_linear_functions(
        jnp.asarray(parameters), jnp.asarray(nb_itvs, jnp.int32), PPI, MAX_ITVS)
    numpy.testing.assert_allclose(areas_t.numpy(), numpy.asarray(areas_j), rtol=1e-5)


def test_clamped_entropy_drops_negative_maps():
    # A map with a huge bin width has a negative approximate entropy:
    # the cumulated entropy leaves it out, the per-map form keeps it.
    (samples, parameters, bin_widths) = _case(2)
    bin_widths[0] = 4000.0
    prob = td.approximate_probability(_t(samples), _t(parameters), PPI, MAX_ITVS)
    per_map = td.approximate_entropy_per_map(prob, _t(bin_widths))
    assert per_map[0] < 0
    numpy.testing.assert_allclose(float(td.approximate_entropy(prob, _t(bin_widths))),
                                  float(per_map[1:].clamp_min(0).sum()), rtol=1e-6)
    numpy.testing.assert_allclose(
        float(td.approximate_entropy(prob, _t(bin_widths))),
        float(jd.approximate_entropy(
            jd.approximate_probability(jnp.asarray(samples), jnp.asarray(parameters), PPI,
                                       MAX_ITVS), jnp.asarray(bin_widths))), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_density_loss_gradient_matches_jax_grad(seed):
    (samples, parameters, _) = _case(seed)
    mask_j = jd.active_mask(jnp.asarray(10, jnp.int32), PPI, MAX_ITVS)

    def loss_j(params):
        prob = jd.approximate_probability(jnp.asarray(samples), params, PPI, MAX_ITVS)
        return jd.loss_density_approximation(prob, params, mask_j, PPI)

    (value_j, grad_j) = jax.value_and_grad(loss_j)(jnp.asarray(parameters))
    params_t = _t(parameters).requires_grad_(True)
    mask_t = td.active_mask(torch.tensor(10, dtype=torch.int32), PPI, MAX_ITVS)
    prob = td.approximate_probability(_t(samples), params_t, PPI, MAX_ITVS)
    value_t = td.loss_density_approximation(prob, params_t, mask_t, PPI)
    (grad_t,) = torch.autograd.grad(value_t, params_t)
    numpy.testing.assert_allclose(float(value_t.detach()), float(value_j), rtol=1e-5)
    # Each table cell sums the interpolation weights of the samples in
    # its two pieces (a scatter-add, order free) plus 2 * p / ppi:
    # entries are O(0.1), float32 sums of a few hundred terms.
    numpy.testing.assert_allclose(grad_t.numpy(), numpy.asarray(grad_j), rtol=1e-5, atol=1e-6)
    # The gradient with respect to the samples: the slope of the piece.
    samples_t = _t(samples).requires_grad_(True)
    torch.sum(td.approximate_probability(samples_t, _t(parameters), PPI, MAX_ITVS)).backward()
    grad_samples_j = jax.grad(lambda s: jnp.sum(jd.approximate_probability(
        s, jnp.asarray(parameters), PPI, MAX_ITVS)))(jnp.asarray(samples))
    numpy.testing.assert_allclose(samples_t.grad.numpy(), numpy.asarray(grad_samples_j),
                                  rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_abs,nb_itvs", [(3.2, 10), (9.99, 10), (10.0, 10), (10.4, 10),
                                             (17.0, 10), (12.5, 20), (31.0, 10), (500.0, 10)])
def test_expand_table(max_abs, nb_itvs):
    table_t = td.init_density_table(NB_MAPS, PPI, MAX_ITVS, nb_itvs)
    table_j = jd.init_density_table(NB_MAPS, PPI, MAX_ITVS, nb_itvs)
    got = td.expand_table(table_t, torch.tensor(max_abs, dtype=torch.float32), PPI, MAX_ITVS)
    expected = jd.expand_table(table_j, jnp.asarray(max_abs, jnp.float32), PPI, MAX_ITVS)
    assert got.nb_itvs_per_side.dtype == torch.int32
    assert int(got.nb_itvs_per_side) == int(expected.nb_itvs_per_side)
    assert int(got.nb_itvs_per_side) <= MAX_ITVS
    # Only the scalar moves.
    assert got.parameters is table_t.parameters


def test_project_density_parameters():
    (_, parameters, _) = _case(4)
    parameters[:, ::7] = -0.5
    parameters[:, 3] = 7.0  # a dead cell that drifted
    mask_t = td.active_mask(torch.tensor(10, dtype=torch.int32), PPI, MAX_ITVS)
    mask_j = jd.active_mask(jnp.asarray(10, jnp.int32), PPI, MAX_ITVS)
    got = td.project_density_parameters(_t(parameters), mask_t)
    expected = jd.project_density_parameters(jnp.asarray(parameters), mask_j)
    assert got.dtype == torch.float32
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(expected))
    assert float(got.min()) == numpy.float32(csts.LOW_PROJECTION)
    assert bool((got[:, mask_t == 0] == numpy.float32(csts.LOW_PROJECTION)).all())
