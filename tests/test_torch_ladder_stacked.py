"""PyTorch port: the gamma ladder as one program over stacked models.

The parts of the stacked ladder step against what they stack, on the CPU
in float32 at 2 x 32 x 32 with three models: the stacked GDN's plain twin
against ``jax.vmap`` of the JAX package's GDN and against the single
plain version model by model; ``encode_stacked`` / ``decode_stacked``
against the single-model transforms and against ``jax.vmap`` of the JAX
package's transforms on weights carried across; the per-model learning
rate at its boundaries; the density ops with a model axis against the
2-D ops row by row; the fp32 decode's phase form against
``conv_transpose2d`` and the JAX decode; the generator's draw order; a
sharded ladder's epoch. Inputs come from numpy seeds. The ``cuda``-marked
tests run the stacked kernel and two fp32 decodes on the card and skip
elsewhere.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu import constants as jcsts
from autoencoder_based_image_compression_tpu.models import conv_eae as jax_eae
from autoencoder_based_image_compression_tpu.ops.gdn import gdn as jax_gdn
from autoencoder_based_image_compression_tpu.ops.gdn import inverse_gdn as jax_inverse_gdn
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.cli.train_ladder import GAMMAS_DEFAULT
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
from autoencoder_based_image_compression_tpu_torch.train import ladder
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    ladder_boundaries,
    learning_rate,
    state_leaves,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_MODELS = 3
GAMMAS = [10000.0, 40000.0, 96000.0]
LATENT = (2, 2, 2, 128)
MAX_ITVS = 16


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _gdn_case(seed, rows=50, models=NB_MODELS):
    rng = numpy.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(rows, models, 128))).astype(numpy.float32)
    raw = rng.uniform(2e-5, 0.01, size=(models, 128, 128)).astype(numpy.float32)
    gamma = 0.5 * (raw + raw.transpose(0, 2, 1))
    beta = rng.uniform(0.5, 1.5, size=(models, 128)).astype(numpy.float32)
    return (x, gamma, beta)


def _models(learn_bin_widths):
    """JAX parameter dicts of three models, and the port's stacked dict."""
    jax_params = [jax_eae.init_conv_eae_params(jax.random.PRNGKey(k), learn_bin_widths)
                  for k in range(NB_MODELS)]
    ported = [params_from_jax({name: numpy.asarray(value) for (name, value) in p.items()})
              for p in jax_params]
    stacked = {name: torch.stack([p[name] for p in ported]) for name in ported[0]}
    return (jax_params, ported, stacked)


def _images(seed=3):
    rng = numpy.random.default_rng(seed)
    return rng.integers(16, 236, size=(2, 32, 32, 1)).astype(numpy.float32)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_stacked_plain_matches_jax_vmap_and_the_single_plain(inverse):
    (x, gamma, beta) = _gdn_case(1)
    fn = jax_inverse_gdn if inverse else jax_gdn
    expected = numpy.asarray(jax.vmap(fn, in_axes=(1, 0, 0), out_axes=1)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    got = gk.gdn_stacked_2d_plain(_t(x), _t(gamma), _t(beta), inverse)
    assert got.shape == (50, NB_MODELS, 128)
    numpy.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)
    for m in range(NB_MODELS):
        single = gk.gdn_2d_plain(_t(x[:, m]), _t(gamma[m]), _t(beta[m]), inverse)
        torch.testing.assert_close(got[:, m], single, rtol=1e-6, atol=1e-7)


def test_gdn_stacked_wrappers_on_the_cpu_and_their_checks():
    (x, gamma, beta) = [_t(a) for a in _gdn_case(2, rows=2 * 4 * 4)]
    got = gk.gdn_stacked_2d(x, gamma, beta, inverse=True)
    assert torch.equal(got, gk.gdn_stacked_2d_plain(x, gamma, beta, inverse=True))
    nhwc = x.reshape(2, 4, 4, NB_MODELS * 128)
    assert torch.equal(gk.gdn_stacked_nhwc(nhwc, gamma, beta, inverse=True),
                       got.reshape(nhwc.shape))
    before = dict(gk.LAUNCHES)
    gk.gdn_stacked_2d(x, gamma, beta)
    assert gk.LAUNCHES == before  # the CPU runs the plain version: nothing launched
    with pytest.raises(ValueError, match="rows, models, 128"):
        gk.gdn_stacked_2d(x[:, :, :64], gamma, beta)
    with pytest.raises(ValueError, match="expected gamma"):
        gk.gdn_stacked_2d(x, gamma[:2], beta)
    with pytest.raises(TypeError, match="fp32"):
        gk.gdn_stacked_2d(x.to(torch.bfloat16), gamma, beta)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_stacked_gradient_matches_autograd_through_the_plain_twin(inverse):
    """``GdnStackedFunction``'s hand-written backward (batched over the
    models) against autograd through the plain twin, within 1e-5 of each
    gradient's largest entry."""
    (x, gamma, beta) = [_t(a) for a in _gdn_case(3, rows=40)]
    grad_out = _t(numpy.random.default_rng(4).normal(size=x.shape).astype(numpy.float32))
    grads = []
    for fn in (lambda *a: gk.GdnStackedFunction.apply(*a, inverse),
               lambda *a: gk.gdn_stacked_2d_plain(*a, inverse)):
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        fn(*leaves).backward(grad_out)
        grads.append([leaf.grad for leaf in leaves])
    for (got, expected) in zip(*grads):
        scale = float(expected.abs().max())
        assert float((got - expected).abs().max()) <= 1e-5 * scale
    # With grad, gdn_stacked_2d goes through the function.
    x_grad = x.clone().requires_grad_(True)
    assert gk.gdn_stacked_2d(x_grad, gamma, beta, inverse).grad_fn is not None


@pytest.mark.parametrize("symmetric", [False, True], ids=["asymmetric", "symmetric"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_a_stack_of_one_model_equals_the_single_model_bit_for_bit(inverse, symmetric):
    """``GdnStackedFunction`` over a stack of one model against
    ``GdnFunction`` on that model: the same output and the same three
    gradients, bit for bit (one backward serves both)."""
    (x, gamma, beta) = [_t(a) for a in _gdn_case(6 + int(inverse), rows=40, models=1)]
    if not symmetric:
        gamma = gamma * torch.triu(torch.ones(128, 128)) + 0.3 * gamma * torch.tril(
            torch.ones(128, 128), -1)
    grad_out = _t(numpy.random.default_rng(7).normal(size=x.shape).astype(numpy.float32))
    stacked = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    single = [t.clone().requires_grad_(True) for t in (x[:, 0], gamma[0], beta[0])]
    out_stacked = gk.GdnStackedFunction.apply(*stacked, inverse)
    out_single = gk.GdnFunction.apply(*single, inverse)
    assert torch.equal(out_stacked[:, 0], out_single)
    out_stacked.backward(grad_out)
    out_single.backward(grad_out[:, 0])
    for (a, b) in zip((stacked[0].grad[:, 0], stacked[1].grad[0], stacked[2].grad[0]),
                      (leaf.grad for leaf in single)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("learn_bin_widths", [False, True])
def test_stacked_transforms_equal_the_single_model_transforms(learn_bin_widths):
    """On the CPU a conv grouped over the models sums each model's terms
    as the single model's conv does: the stacked transforms equal the
    single-model ones, the decode against ``conv_transpose2d`` (what the
    stacked decode runs)."""
    (_, ported, stacked) = _models(learn_bin_widths)
    images = torch.from_numpy(_images())
    y = conv_eae.encode_stacked(stacked, images, learn_bin_widths)
    assert y.shape == (2, 2, 2, NB_MODELS * 128)
    reconstructions = conv_eae.decode_stacked(stacked, y, learn_bin_widths)
    assert reconstructions.shape == (2, 32, 32, NB_MODELS)
    for m in range(NB_MODELS):
        y_m = conv_eae.encode(ported[m], images, learn_bin_widths)
        torch.testing.assert_close(y[..., m * 128:(m + 1) * 128], y_m, rtol=1e-6, atol=1e-7)
        single = conv_eae._decode(ported[m], y_m, learn_bin_widths,
                                  conv_eae.conv_transpose_same)
        torch.testing.assert_close(reconstructions[..., m:m + 1], single, rtol=1e-6,
                                   atol=1e-6 * float(single.abs().max()))
    norms = conv_eae.weight_l2_norms(stacked)
    for m in range(NB_MODELS):
        torch.testing.assert_close(norms[m], conv_eae.weight_l2_norm(ported[m]), rtol=1e-6,
                                   atol=0.0)


# (input maps a model, output maps a model, kernel, stride, transposed, input size)
SITES = {"conv_1": (1, 128, 9, 4, False, 32), "conv_2": (128, 128, 5, 2, False, 8),
         "conv_3": (128, 128, 5, 2, False, 4), "tconv_4": (128, 128, 5, 2, True, 2),
         "tconv_5": (128, 128, 5, 2, True, 4), "tconv_6": (128, 1, 9, 4, True, 8)}


@pytest.mark.parametrize("site", sorted(SITES))
def test_a_conv_site_grouped_or_on_channel_slices_computes_the_same(site):
    """Each conv site of the stacked transforms, as one conv grouped over
    the models and as one conv a model on the models' channel slices:
    the same outputs and gradients on the CPU (rtol 1e-6)."""
    (nb_in, nb_out, kernel, stride, transposed, size) = SITES[site]
    rng = numpy.random.default_rng(len(site))
    maps = nb_in if site == "conv_1" else NB_MODELS * nb_in
    x = _t(rng.normal(size=(2, size, size, maps)).astype(numpy.float32))
    shape = ((NB_MODELS, nb_in, nb_out, kernel, kernel) if transposed
             else (NB_MODELS, nb_out, nb_in, kernel, kernel))
    w = _t(0.05 * rng.normal(size=shape).astype(numpy.float32))
    results = []
    for separate in (set(), {site}):
        (x_in, w_in) = (x.clone().requires_grad_(True), w.clone().requires_grad_(True))
        out = conv_eae._conv_stacked(site, x_in, w_in, stride, transposed, separate)
        out.backward(torch.ones_like(out))
        results.append((out.detach(), x_in.grad, w_in.grad))
    assert results[0][0].shape == (2, size * stride if transposed else size // stride,
                                   size * stride if transposed else size // stride,
                                   NB_MODELS * nb_out)
    for (grouped, separate) in zip(*results):
        torch.testing.assert_close(separate, grouped, rtol=1e-6,
                                   atol=1e-6 * float(grouped.abs().max()))


@pytest.mark.parametrize("learn_bin_widths", [False, True])
def test_stacked_transforms_match_jax_vmap(learn_bin_widths):
    """``jax.vmap`` of the JAX package's encode / decode over stacked
    parameters (what its ladder runs), on the same weights: encode within
    rtol 1e-5 / atol 1e-4 and decode within rtol 1e-5 / atol 1e-3, the
    single-model transforms' bounds (``tests/test_torch_transforms.py``)."""
    (jax_params, _, stacked) = _models(learn_bin_widths)
    jax_stacked = {name: jnp.stack([p[name] for p in jax_params]) for name in jax_params[0]}
    images = _images(6)
    expected = numpy.asarray(jax.vmap(jax_eae.encode, in_axes=(0, None, None))(
        jax_stacked, jnp.asarray(images), learn_bin_widths))  # (M, B, h, w, 128)
    got = conv_eae.encode_stacked(stacked, torch.from_numpy(images), learn_bin_widths)
    got = got.reshape(2, 2, 2, NB_MODELS, 128).permute(3, 0, 1, 2, 4).numpy()
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-4)
    latents = numpy.round(expected)
    expected_rec = numpy.asarray(jax.vmap(jax_eae.decode, in_axes=(0, 0, None))(
        jax_stacked, jnp.asarray(latents), learn_bin_widths))  # (M, B, H, W, 1)
    side_by_side = torch.from_numpy(latents).permute(1, 2, 3, 0, 4).reshape(2, 2, 2, -1)
    got_rec = conv_eae.decode_stacked(stacked, side_by_side, learn_bin_widths)
    numpy.testing.assert_allclose(got_rec.permute(3, 0, 1, 2).numpy()[..., None], expected_rec,
                                  rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", range(len(GAMMAS_DEFAULT)))
def test_stacked_learning_rate_at_and_around_each_models_boundaries(k):
    """The ``(M,)`` rates of the ``(M, 2)`` boundary form: model ``k`` at
    and around its own boundaries, the others elsewhere; each equal to the
    single-model rate of its gamma at its count, and within rtol 1e-6 of
    the JAX ladder's ``LR_EAE * 0.1 ** decays``."""
    boundaries = ladder_boundaries(GAMMAS_DEFAULT, "cpu")
    assert boundaries.shape == (len(GAMMAS_DEFAULT), 2)
    own = jcsts.lr_boundaries(GAMMAS_DEFAULT[k])
    for (i, boundary) in enumerate(own):
        for (step, decays) in ((boundary - 1, i), (boundary, i + 1), (boundary + 1, i + 1)):
            counts = torch.tensor([step if m == k else 37 * m for m in
                                   range(len(GAMMAS_DEFAULT))], dtype=torch.int32)
            got = learning_rate(boundaries, counts)
            assert got.shape == (len(GAMMAS_DEFAULT),) and got.dtype == torch.float32
            for (m, gamma) in enumerate(GAMMAS_DEFAULT):
                assert torch.equal(got[m], learning_rate(gamma, counts[m]))
            expected = jcsts.LR_EAE * jnp.power(0.1, jnp.float32(decays))
            numpy.testing.assert_allclose(float(got[k]), float(expected), rtol=1e-6)


def _density_case(seed):
    rng = numpy.random.default_rng(seed)
    width = dens.table_width(csts.NB_POINTS_PER_INTERVAL, MAX_ITVS)
    tables = dens.init_density_table(128, csts.NB_POINTS_PER_INTERVAL, MAX_ITVS, 10)
    parameters = tables.parameters.numpy()[None] * rng.uniform(
        0.5, 1.5, size=(NB_MODELS, 128, width)).astype(numpy.float32)
    extents = numpy.array([4, 10, 16], numpy.int32)
    samples = (3.0 * rng.standard_normal((NB_MODELS, 128, 300))).clip(-9.5, 9.5)
    bin_widths = rng.uniform(0.8, 2.0, (NB_MODELS, 128)).astype(numpy.float32)
    return (_t(samples.astype(numpy.float32)), _t(parameters.astype(numpy.float32)),
            _t(extents), _t(bin_widths))


@pytest.mark.parametrize("seed", [0, 1])
def test_density_ops_with_a_model_axis_equal_the_2d_ops_row_by_row(seed):
    (samples, parameters, extents, bin_widths) = _density_case(seed)
    (ppi, width) = (csts.NB_POINTS_PER_INTERVAL, parameters.shape[-1])
    masks = dens.active_mask(extents, ppi, MAX_ITVS)
    assert masks.shape == (NB_MODELS, width)
    prob = dens.approximate_probability(samples, parameters, ppi, MAX_ITVS)
    stacked = {
        "prob": prob,
        "diff": dens.differential_entropy(prob),
        "per_map": dens.approximate_entropy_per_map(prob, bin_widths),
        "entropy": dens.approximate_entropy(prob, bin_widths),
        "loss": dens.loss_density_approximation(prob, parameters, masks, ppi),
        "area": dens.area_under_piecewise_linear_functions(parameters, extents, ppi, MAX_ITVS),
        "projected": dens.project_density_parameters(parameters - 0.3, masks),
        "extent": dens.expand_table(dens.DensityTable(parameters, extents),
                                    torch.tensor([3.2, 12.5, 30.0]), ppi,
                                    MAX_ITVS).nb_itvs_per_side,
    }
    assert stacked["entropy"].shape == stacked["loss"].shape == (NB_MODELS,)
    for m in range(NB_MODELS):
        mask = dens.active_mask(extents[m], ppi, MAX_ITVS)
        assert torch.equal(masks[m], mask)
        prob_m = dens.approximate_probability(samples[m], parameters[m], ppi, MAX_ITVS)
        single = {
            "prob": prob_m,
            "diff": dens.differential_entropy(prob_m),
            "per_map": dens.approximate_entropy_per_map(prob_m, bin_widths[m]),
            "entropy": dens.approximate_entropy(prob_m, bin_widths[m]),
            "loss": dens.loss_density_approximation(prob_m, parameters[m], mask, ppi),
            "area": dens.area_under_piecewise_linear_functions(parameters[m], extents[m], ppi,
                                                               MAX_ITVS),
            "projected": dens.project_density_parameters(parameters[m] - 0.3, mask),
            "extent": dens.expand_table(dens.DensityTable(parameters[m], extents[m]),
                                        torch.tensor([3.2, 12.5, 30.0])[m], ppi,
                                        MAX_ITVS).nb_itvs_per_side,
        }
        for (name, value) in single.items():
            torch.testing.assert_close(stacked[name][m], value, rtol=1e-6, atol=0.0,
                                       msg=f"{name}, model {m}")


def _trained(learn_bin_widths):
    """The committed trained model: JAX parameters and the port's."""
    path = os.path.join(REPO, "results", "eae",
                        "learning_bw/0dot5_10000" if learn_bin_widths else "fixed_bw/1_10000",
                        "params_trained.npz")
    return (jax_load_params_artifact(path)[0], params_from_jax(load_params_artifact(path)[0]))


@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_fp32_decode_phase_form_matches_conv_transpose_and_jax(learn_bin_widths):
    """Without grad, ``decode`` runs its transposed convs as forward convs
    into their output phases: on the trained model within rtol 1e-5 and
    1e-5 of the largest pixel of ``conv_transpose2d`` (sums in another
    order), and within the fp32 decode's bound against the JAX decode
    (rtol 1e-5, atol 1e-3, ``tests/test_torch_transforms.py``). With grad
    it runs ``conv_transpose2d``."""
    (params_jax, params) = _trained(learn_bin_widths)
    y = numpy.asarray(jax_eae.encode(params_jax, jnp.asarray(_images(7)), learn_bin_widths))
    latents = numpy.round(y).astype(numpy.float32)
    got = conv_eae.decode(params, torch.from_numpy(latents), learn_bin_widths)
    transposed = conv_eae._decode(params, torch.from_numpy(latents), learn_bin_widths,
                                  conv_eae.conv_transpose_same)
    assert got.shape == transposed.shape == (2, 32, 32, 1)
    torch.testing.assert_close(got, transposed, rtol=1e-5,
                               atol=1e-5 * float(transposed.abs().max()))
    expected = numpy.asarray(jax_eae.decode(params_jax, jnp.asarray(latents),
                                            learn_bin_widths))
    numpy.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-3)
    y_grad = torch.from_numpy(latents).requires_grad_(True)
    with_grad = conv_eae.decode(params, y_grad, learn_bin_widths)
    assert torch.equal(with_grad.detach(), transposed)
    with pytest.raises(ValueError, match="no phase form"):
        conv_eae.conv_transpose_phases(y_grad, params["weights_4"], 4)


def test_tconv6_phase_kernel_is_built_once_per_kernel_tensor():
    w9 = torch.randn((8, 1, 9, 9), generator=torch.Generator().manual_seed(0))
    first = conv_eae._tconv6_phase_kernel(w9)
    assert first.shape == (16, 8, 3, 3)
    assert conv_eae._tconv6_phase_kernel(w9) is first
    w9.mul_(2.0)
    assert torch.equal(conv_eae._tconv6_phase_kernel(w9), 2.0 * first)


def _noise(seed, shape=LATENT):
    rng = numpy.random.default_rng(seed)
    return _t(rng.uniform(-0.5, 0.5, size=shape).astype(numpy.float32))


def test_a_generator_draws_all_models_at_once_density_phase_first():
    """From a generator, each phase of a stacked step draws ``(M,
    *latent)`` at once, model ``m``'s noise at entry ``m``, the density
    phase first: the step equals the step fed those draws."""
    fns = ladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS)
    start = ladder.init_ladder_state(torch.Generator().manual_seed(1), GAMMAS,
                                     max_itvs=MAX_ITVS, device="cpu")
    batch = torch.from_numpy(_images(8))
    got = fns["train_step"](start, batch, torch.Generator().manual_seed(5))
    generator = torch.Generator().manual_seed(5)
    (fct, eae) = [torch.rand((NB_MODELS, *LATENT), generator=generator) - 0.5
                  for _ in range(2)]
    expected = fns["train_step"](start, batch, [(fct[m], eae[m]) for m in range(NB_MODELS)])
    for (a, b) in zip(state_leaves(got), state_leaves(expected)):
        assert torch.equal(a, b)


def test_sharded_ladder_epoch_runs_block_by_block():
    """A sharded ladder's ``train_epoch``: each block's whole epoch with
    its own models' noise, equal to the unsharded ladder's epoch at the
    sharded step's bound (rtol 1e-6 / atol 1e-7); with a generator, block
    after block."""
    fns = ladder.make_ladder_step_fns(GAMMAS, max_itvs=MAX_ITVS)
    start = ladder.init_ladder_state(torch.Generator().manual_seed(2), GAMMAS,
                                     max_itvs=MAX_ITVS, device="cpu")
    rng = numpy.random.default_rng(9)
    dataset = _t(rng.integers(16, 236, size=(6, 32, 32, 1)).astype(numpy.uint8))
    rows = rng.permutation(6).reshape(3, 2)
    noise = [[(_noise(100 + 10 * i + m), _noise(200 + 10 * i + m)) for m in range(NB_MODELS)]
             for i in range(3)]
    plain = fns["train_epoch"](start, dataset, rows, noise)
    mesh = make_mesh(1, devices=["cpu"] * NB_MODELS)
    sharded = fns["train_epoch"](ladder.shard_ladder_state(start, mesh), dataset, rows, noise)
    assert isinstance(sharded, ladder.LadderShards)
    for (a, b) in zip(state_leaves(sharded.fetch()), state_leaves(plain)):
        numpy.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    # A shared generator: block 0's epoch draws first, then block 1's, ...
    shards = ladder.shard_ladder_state(start, mesh)
    got = fns["train_epoch"](shards, dataset, rows, torch.Generator().manual_seed(4)).fetch()
    generator = torch.Generator().manual_seed(4)
    one = ladder.make_ladder_step_fns
    blocks = []
    for m in range(NB_MODELS):
        block = shards.blocks[m]
        step = one(GAMMAS[m:m + 1], max_itvs=MAX_ITVS)["train_step"]
        for batch_rows in rows:
            block = step(block, dataset[torch.as_tensor(batch_rows)], generator)
        blocks.append(block)
    expected = ladder.LadderShards(mesh, "data", NB_MODELS, dict(enumerate(blocks))).fetch()
    for (a, b) in zip(state_leaves(got), state_leaves(expected)):
        assert torch.equal(a, b)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; chip_smoke.py runs this check on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2560 + 37, 40960])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_stacked_kernel_matches_its_twin_and_the_single_kernel(inverse, rows):
    _cuda()
    (x, gamma, beta) = [_t(a).cuda() for a in _gdn_case(10, rows=rows, models=7)]
    before = gk.LAUNCHES["igdn_f32_stacked" if inverse else "gdn_f32_stacked"]
    got = gk.gdn_stacked_2d(x, gamma, beta, inverse=inverse)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["igdn_f32_stacked" if inverse else "gdn_f32_stacked"] == before + 1
    torch.testing.assert_close(got, gk.gdn_stacked_2d_plain(x, gamma, beta, inverse),
                               rtol=1e-5, atol=1e-6)
    for m in (0, 6):
        assert torch.equal(got[:, m], gk.gdn_2d(x[:, m].contiguous(), gamma[m], beta[m],
                                                inverse=inverse))


@pytest.mark.cuda
def test_cuda_two_fp32_decodes_are_equal():
    _cuda()
    (_, ported, _) = _models(True)
    params = {name: value.cuda() for (name, value) in ported[0].items()}
    y = torch.round(3.0 * torch.randn((4, 32, 48, 128), device="cuda",
                                      generator=torch.Generator("cuda").manual_seed(0)))
    assert torch.equal(conv_eae.decode(params, y, True), conv_eae.decode(params, y, True))
