"""Minnen et al.'s joint autoregressive and hierarchical prior
(``models/minnen2018.py``, trained by ``train/hyperprior.py``) against
its plain reference (``models/minnen2018_plain.py``), on the CPU at the
published widths (N = M = 192) on two RGB images of 64 x 64 with seeded
random weights; the causality of its context model; the Gaussian
conditional with and without a mean; the benchmark's frozen copy of the
reference; the GDN wrappers' checks of the width; the command line. The
``cuda``-marked tests run the 192-channel kernels and the graphed step on
the card (``-m cuda --noconftest``: this file imports no JAX).

Tolerances: both sides compute in fp32 and differ only in the order of
their sums (the program's NHWC convs, its GDN through ``x^2 @ gamma^T``,
its one pass over both sides of the density's intervals and its mask
made by a comparison, against NCHW convs, an einsum, two passes and a
mask made tap by tap), about 1e-6 of a value: 1e-5 relative on a
likelihood, a rate or a loss, and 1e-4 of a leaf's largest entry on a
gradient, as ``tests/test_torch_hyperprior.py`` holds the hyperprior.
Adam's first steps move each entry by about the rate 1e-4 whatever its
gradient, so an entry whose gradient is rounding alone may move the
other way (an entry of ``ep_b1`` whose gradient is 6e-7 of its leaf's
largest did): after three steps a leaf's change is held within 1 % of
the reference's change in norm over the entries whose first gradient in
the reference is at least 1e-5 of the leaf's largest (at 64 x 64 many
taps of the hyper networks see only padding, and their gradient is 0).
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.cli import train_hyperprior as cli
from autoencoder_based_image_compression_tpu_torch.models import minnen2018 as mb
from autoencoder_based_image_compression_tpu_torch.models import minnen2018_plain as plain
from autoencoder_based_image_compression_tpu_torch.ops import entropy_models as em
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.train import epoch_graph
from autoencoder_based_image_compression_tpu_torch.train import hyperprior as steps
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import load_checkpoint
from autoencoder_based_image_compression_tpu_torch.train.loop import run_epoch_training
from autoencoder_based_image_compression_tpu_torch.train.state import state_leaves
from autoencoder_based_image_compression_tpu_torch.utils import tracing
from codec_bench.reference import minnen2018 as frozen

LMBDA = 0.013
(BATCH, SIDE) = (2, 64)


def _weights(seed, device="cpu"):
    """Seeded random parameters: the initial ones, with every GDN variable
    and the density drawn at random (a gamma far from symmetric) and the
    biases moved off zero."""
    generator = torch.Generator().manual_seed(seed)
    params = mb.init_params(generator)
    for (name, value) in params.items():
        if "_gamma" in name:
            params[name] = torch.sqrt(0.05 * torch.rand(value.shape, generator=generator)
                                      + em.PEDESTAL)
        elif "_beta" in name:
            params[name] = torch.sqrt(0.5 + torch.rand(value.shape, generator=generator))
        elif name.startswith("fd_") or "_b" in name:
            params[name] = value + 0.1 * torch.randn(value.shape, generator=generator)
    return {name: value.to(device) for (name, value) in params.items()}


def _batch(seed, nb=BATCH, device="cpu"):
    generator = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (nb, SIDE, SIDE, 3), dtype=torch.uint8,
                         generator=generator).to(device)


def _noises(seed, device="cpu", nb=BATCH):
    return plain.draw_noises(torch.Generator(device).manual_seed(seed), nb, SIDE, SIDE, device)


def _state(params):
    return steps.state_of({name: value.clone() for (name, value) in params.items()}, mb)


def _close(got, expected, rtol):
    assert float(abs(got - expected)) <= rtol * float(abs(expected)), (float(got),
                                                                       float(expected))


def test_the_model_has_the_published_widths():
    shapes = mb.param_shapes()
    assert len(shapes) == 59
    assert sum(int(numpy.prod(shape)) for shape in shapes.values()) == 14_127_011
    assert shapes["ga_gamma1"] == (192, 192) and shapes["ga_w4"] == (192, 192, 5, 5)
    assert shapes["hs_w2"] == (192, 288, 5, 5) and shapes["hs_w3"] == (384, 288, 3, 3)
    assert shapes["cm_w"] == (384, 192, 5, 5)
    assert [shapes[f"ep_w{i}"][:2] for i in (1, 2, 3)] == [(640, 768), (512, 640), (384, 512)]
    assert int(mb.context_mask().sum()) == 12
    assert torch.equal(mb.context_mask(), plain.causal_mask(5))


def test_forward_likelihoods_rate_and_gradients_match_the_reference():
    params = _weights(1)
    batch = _batch(2)
    (noise_y, noise_z) = _noises(3)
    images = batch.float() / 255.0
    x = plain.nchw(images)
    y = mb.analysis(params, images)
    torch.testing.assert_close(plain.nchw(y), plain.analysis(params, x), rtol=1e-5, atol=1e-5)
    (y_tilde, z_tilde) = (y + noise_y, mb.hyper_analysis(params, y) + noise_z)
    psi = mb.hyper_synthesis(params, z_tilde)
    (sigma, mu) = mb.entropy_parameters(params, mb.context_model(params, y_tilde), psi)
    lik_z = em.factorized_likelihood(mb.hyperprior.density_params(params), z_tilde)
    lik_y = em.gaussian_likelihood(y_tilde, sigma, mu)
    (ref_y_tilde, ref_z_tilde) = (plain.nchw(y_tilde), plain.nchw(z_tilde))
    ref_psi = plain.hyper_synthesis(params, ref_z_tilde)
    (ref_sigma, ref_mu) = plain.entropy_parameters(
        params, plain.context_model(params, ref_y_tilde), ref_psi)
    torch.testing.assert_close(plain.nchw(mu), ref_mu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(plain.nchw(sigma), ref_sigma, rtol=1e-5, atol=1e-5)
    ref_z = plain.factorized_likelihood(params, ref_z_tilde)
    ref_lik_y = plain.gaussian_likelihood(ref_y_tilde, ref_sigma, ref_mu)
    torch.testing.assert_close(plain.nchw(lik_z), ref_z, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(plain.nchw(lik_y), ref_lik_y, rtol=1e-5, atol=1e-9)
    # The means matter: a zero mean gives another rate.
    assert float(mu.abs().max()) > 0.05
    assert not torch.allclose(lik_y, em.gaussian_likelihood(y_tilde, sigma), rtol=1e-3)

    leaves = {name: value.clone().requires_grad_(True) for (name, value) in params.items()}
    (loss, parts) = mb.rd_loss(leaves, images, (noise_y, noise_z), LMBDA)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_leaves = {name: value.clone().requires_grad_(True) for (name, value) in params.items()}
    (ref_loss, ref_bpp, ref_mse, _) = plain.loss_terms(ref_leaves, batch, LMBDA,
                                                       (noise_y, noise_z))
    ref_grads = dict(zip(ref_leaves, torch.autograd.grad(ref_loss,
                                                         list(ref_leaves.values()))))
    for (got, expected) in ((loss, ref_loss), (parts["bpp"], ref_bpp), (parts["mse"], ref_mse)):
        _close(got.detach(), expected.detach(), 1e-5)
    (bpp_y, bpp_z) = (float(parts["bpp_y"].detach()), float(parts["bpp_z"].detach()))
    assert 0 < bpp_z < bpp_y
    assert set(grads) == set(ref_grads) and len(grads) == 59
    for (name, expected) in ref_grads.items():
        assert float(expected.abs().max()) > 0, name
        torch.testing.assert_close(grads[name], expected, rtol=1e-4,
                                   atol=1e-4 * float(expected.abs().max()), msg=name)


def test_three_steps_through_train_epoch_match_three_reference_steps():
    params = _weights(4)
    dataset = _batch(5, nb=3 * BATCH)
    fns = steps.make_hyperprior_step_fns(LMBDA, mb)
    rows = numpy.arange(3 * BATCH).reshape(3, BATCH)
    got = run_epoch_training(dataset, _state(params), fns, BATCH, 3,
                             torch.Generator().manual_seed(6), permutation=rows.reshape(-1))
    assert int(got.step) == 3 and int(got.opt.count) == 3
    ref = plain.State(params)
    generator = torch.Generator().manual_seed(6)
    for step_rows in rows:
        ref.step(dataset[torch.as_tensor(step_rows)], plain.draw_noises(
            generator, BATCH, SIDE, SIDE, "cpu"), LMBDA)
    norm = torch.linalg.vector_norm
    for (name, start) in params.items():
        (change, ref_change) = (steps.params_of(got, mb)[name] - start,
                                ref.params[name] - start)
        gradient = ref.first_gradient[name].abs()
        kept = gradient >= 1e-5 * gradient.max()
        assert float(norm((change - ref_change)[kept])) <= 0.01 * float(
            norm(ref_change[kept])), name


def test_the_context_model_reads_only_the_latents_before_each_position():
    """Whatever ``y~`` holds at a position and after it in raster order,
    ``phi`` before that position stays as it was; at the position itself
    too (type A), and the position to its right in its row moves."""
    params = _weights(30)
    generator = torch.Generator().manual_seed(31)
    y_tilde = torch.randn((1, 6, 7, mb.M), generator=generator)
    base = mb.context_model(params, y_tilde)
    order = torch.arange(6 * 7).reshape(6, 7)
    for (row, col) in ((0, 0), (2, 3), (3, 6), (5, 6)):
        at = int(order[row, col])
        later = (order >= at)[None, :, :, None]
        changed = y_tilde + 1e3 * later * torch.randn(y_tilde.shape, generator=generator)
        phi = mb.context_model(params, changed)
        # 1e3 on every later latent; a leak of one masked tap would move phi
        # by about 1e3 * |w| ~ 10, against rounding of about 1e-5.
        before = (order <= at)[None, :, :, None].expand_as(phi)
        torch.testing.assert_close(phi[before], base[before], rtol=0, atol=1e-4)
        if col + 1 < 7:
            assert float((phi[0, row, col + 1] - base[0, row, col + 1]).abs().max()) > 1.0


def test_masked_taps_get_no_gradient_and_adam_never_moves_them():
    params = _weights(32)
    mask = mb.context_mask()
    leaves = {name: value.clone().requires_grad_(True) for (name, value) in params.items()}
    (loss, _) = mb.rd_loss(leaves, _batch(33).float() / 255.0, _noises(34), LMBDA)
    (grad,) = torch.autograd.grad(loss, [leaves["cm_w"]])
    assert bool((grad * (1 - mask) == 0).all()) and float((grad * mask).abs().max()) > 0
    step = steps.make_hyperprior_step_fns(LMBDA, mb)["train_step"]
    state = _state(params)
    for seed in (35, 36):
        state = step(state, _batch(seed), _noises(seed + 10))
    moved = steps.params_of(state, mb)["cm_w"]
    masked = (1 - mask).bool().expand_as(moved)
    assert torch.equal(moved[masked], params["cm_w"][masked])
    assert float((moved - params["cm_w"])[~masked].abs().max()) > 0


def test_gaussian_likelihood_without_a_mean_is_unchanged():
    generator = torch.Generator().manual_seed(37)
    y = 3.0 * torch.randn((2, 4, 4, 192), generator=generator)
    sigma = torch.rand((2, 4, 4, 192), generator=generator) * 2.0
    sigma_b = em.lower_bound(sigma, em.SCALE_BOUND)
    upper = em._standard_cumulative((0.5 - torch.abs(y)) / sigma_b)
    lower = em._standard_cumulative((-0.5 - torch.abs(y)) / sigma_b)
    written_out = em.lower_bound(upper - lower, em.LIKELIHOOD_BOUND)
    assert torch.equal(em.gaussian_likelihood(y, sigma), written_out)
    assert torch.equal(em.gaussian_likelihood(y, sigma, torch.zeros_like(y)), written_out)
    mean = torch.randn(y.shape, generator=generator)
    assert torch.equal(em.gaussian_likelihood(y, sigma, mean),
                       em.gaussian_likelihood(y - mean, sigma))


def test_evaluation_matches_the_reference():
    params = _weights(7)
    batch = _batch(8)
    got = steps.make_hyperprior_step_fns(LMBDA, mb)["evaluation"](_state(params), batch)
    expected = plain.evaluate(params, batch, LMBDA)
    for name in ("bpp", "mse", "psnr", "loss"):
        _close(got[name], expected[name], 1e-5)
    _close(got["bpp_y"] + got["bpp_z"], expected["bpp"], 1e-5)


def test_the_step_marks_its_phases_in_order():
    fns = steps.make_hyperprior_step_fns(LMBDA, mb)
    state = _state(_weights(9))
    dataset = _batch(10)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset,
                                       torch.arange(BATCH).reshape(1, BATCH),
                                       torch.Generator().manual_seed(1))
    program.load(state, dataset, torch.arange(BATCH).reshape(1, BATCH), None)
    recorder = tracing.Recorder()
    with tracing.recording(recorder):
        program.step(program.buffers, program.counter)
    assert recorder.names == (["step", "forward", "entropy", "context", "synthesis",
                               "backward"] + ["gdn_backward_begin", "gdn_backward_end"] * 6
                              + ["optimizer", "step_end"])
    stamps = 1000 * numpy.cumsum(numpy.ones((2, len(recorder.names)), dtype=numpy.int64),
                                 axis=1)
    assert epoch_graph.phase_ms(recorder.names, stamps) == pytest.approx(
        {"gather": 1e-3, "forward": 4e-3, "backward": 13e-3, "optimizer": 1e-3,
         "gdn_backward": 6e-3, "entropy": 1e-3, "context": 1e-3, "step": 19e-3})


def test_the_benchmark_copy_of_the_reference_gives_the_same_numbers():
    params = _weights(11)
    batch = _batch(12)
    noises = _noises(13)
    answers = []
    for module in (plain, frozen):
        state = module.State(params)
        (loss, grads) = state.gradients(batch, noises, LMBDA)
        answers.append((loss, grads, module.evaluate(params, batch, LMBDA)))
    ((loss_a, grads_a, eval_a), (loss_b, grads_b, eval_b)) = answers
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(grads_a[name], grads_b[name]) for name in grads_a)
    assert all(torch.equal(eval_a[name], eval_b[name]) for name in eval_a)


@pytest.mark.parametrize("channels", [128, 192])
def test_the_gdn_wrappers_take_128_and_192_channels(channels):
    generator = torch.Generator().manual_seed(channels)
    x = torch.randn((16, channels), generator=generator)
    gamma = 0.01 * torch.rand((channels, channels), generator=generator) + 0.1 * torch.eye(
        channels)
    beta = torch.ones(channels)
    for inverse in (False, True):
        expected = gdn_kernel.gdn_2d_plain(x, gamma, beta, inverse)
        assert torch.equal(gdn_kernel.gdn_2d(x, gamma, beta, inverse), expected)
        assert torch.equal(gdn_kernel.gdn_nhwc(x.reshape(1, 4, 4, channels), gamma, beta,
                                               inverse).reshape(16, channels), expected)
    operands = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0),
                torch.randn((16, 1, channels), generator=generator))
    for (got, expected) in zip(gdn_kernel.gdn_backward(*operands, False, stacked=False),
                               gdn_kernel.gdn_backward_plain(*operands, False)):
        assert torch.equal(got, expected)


@pytest.mark.parametrize("call", ["width 64", "width 256", "bf16 at 192", "quantise at 192",
                                  "stacked at 192", "stacked nhwc at 192",
                                  "gamma of another width"])
def test_the_gdn_wrappers_refuse_other_widths_and_variants(call):
    def operands(channels, rows=8):
        return (torch.randn((rows, channels)), torch.eye(channels), torch.ones(channels))

    (x, gamma, beta) = operands(192)
    if call.startswith("width"):
        (x, gamma, beta) = operands(int(call.split()[1]))
        with pytest.raises(ValueError, match=r"\(rows, 128 or 192\)"):
            gdn_kernel.gdn_2d(x, gamma, beta)
        with pytest.raises(ValueError, match=r"\(rows, 128 or 192\)"):
            gdn_kernel.gdn_nhwc(x.reshape(1, 2, 4, -1), gamma, beta)
    elif call == "bf16 at 192":
        with pytest.raises(TypeError, match="bf16 at 128 channels only"):
            gdn_kernel.gdn_2d(x.to(torch.bfloat16), gamma, beta)
    elif call == "quantise at 192":
        with pytest.raises(ValueError, match=r"\(rows, 128\)"):
            gdn_kernel.gdn_quantize_2d(x, gamma, beta, torch.ones(192))
    elif call == "stacked at 192":
        with pytest.raises(ValueError, match=r"\(rows, models, 128\)"):
            gdn_kernel.gdn_stacked_2d(x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0))
    elif call == "stacked nhwc at 192":
        with pytest.raises(ValueError, match="128"):
            gdn_kernel.gdn_stacked_nhwc(x.reshape(1, 2, 4, 192), gamma.unsqueeze(0),
                                        beta.unsqueeze(0))
    else:
        with pytest.raises(ValueError, match=r"gamma \(192, 192\) and beta \(192,\)"):
            gdn_kernel.gdn_2d(x, torch.eye(128), torch.ones(128))


def test_the_command_line_trains_the_model_it_names(tmp_path):
    crops = _batch(14, nb=4).numpy()
    numpy.save(tmp_path / "crops.npy", crops)
    root = str(tmp_path / "results")
    state = cli.main(["--model", "minnen2018", "--path_to_training_data",
                      str(tmp_path / "crops.npy"), "--batch_size", "2", "--results_root", root,
                      "--device", "cpu"])
    path = os.path.join(root, "lambda_0dot013", "model")
    with open(path + ".json") as file:
        meta = json.load(file)
    assert meta["part_complete"] and meta["step"] == 2
    assert state.params["all"].shape == (steps.size_of(mb),)
    template = steps.init_hyperprior_state(torch.Generator().manual_seed(99), "cpu", mb)
    loaded = load_checkpoint(path, template)
    for (a, b) in zip(state_leaves(loaded), state_leaves(state), strict=True):
        assert torch.equal(a, b)


# --- on the card ------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the 192-channel GDN kernels, CUDA graphs)")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [131072, 32768, 8192, 8192 + 37])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_cuda_192_channel_kernels_against_their_twins(rows, inverse):
    """The forward at fp32's tolerance (rtol 1e-5, atol 1e-6), and each
    gradient within 1e-5 of its largest entry (only the order of the sums
    differs), with a gamma that is not symmetric."""
    _cuda()
    generator = torch.Generator("cuda").manual_seed(rows + int(inverse))
    x = 4.0 * torch.randn((rows, 192), device="cuda", generator=generator)
    gamma = 0.02 * torch.rand((192, 192), device="cuda", generator=generator)
    gamma = gamma * torch.triu(torch.ones_like(gamma)) + 0.1 * torch.eye(192, device="cuda")
    beta = 1.0 + 0.5 * torch.rand((192,), device="cuda", generator=generator)
    upstream = torch.randn(x.shape, device="cuda", generator=generator)
    gdn_kernel.reset_launch_counts()
    got = gdn_kernel.gdn_2d(x, gamma, beta, inverse)
    torch.testing.assert_close(got, gdn_kernel.gdn_2d_plain(x, gamma, beta, inverse),
                               rtol=1e-5, atol=1e-6)
    operands = (x.unsqueeze(1), gamma.unsqueeze(0), beta.unsqueeze(0), upstream.unsqueeze(1))
    kernel = gdn_kernel.gdn_backward(*operands, inverse, stacked=False)
    for (a, b) in zip(kernel, gdn_kernel.gdn_backward_plain(*operands, inverse)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    again = gdn_kernel.gdn_backward(*operands, inverse, stacked=False)
    assert all(torch.equal(a, b) for (a, b) in zip(kernel, again))
    forward = "igdn_f32_192" if inverse else "gdn_f32_192"
    assert gdn_kernel.LAUNCH_ROWS == {(forward, rows): 1, (forward + "_backward", rows): 2,
                                      ("gdn_backward_reduce_192", (rows, 1)): 2}


@pytest.mark.cuda
def test_cuda_graphed_step_against_the_eager_step_and_its_launches():
    _cuda()
    params = _weights(15, "cuda")
    (batch, side) = (8, 256)
    generator = torch.Generator().manual_seed(16)
    dataset = torch.randint(0, 256, (3 * batch, side, side, 3), dtype=torch.uint8,
                            generator=generator).cuda()
    rows = numpy.arange(3 * batch).reshape(3, batch)
    fns = steps.make_hyperprior_step_fns(LMBDA, mb)
    gdn_kernel.reset_launch_counts()
    captures = len(epoch_graph.CAPTURES)
    graphed = fns["train_epoch"](_state(params), dataset, rows,
                                 torch.Generator("cuda").manual_seed(17))
    # Two steps' launches a capture (the warm-up and the capture), none a
    # replay, all at 192 channels; none at 128.
    launched = {name: n for (name, n) in gdn_kernel.LAUNCHES.items() if n}
    assert launched == {"gdn_f32_192": 6, "igdn_f32_192": 6, "gdn_f32_192_backward": 6,
                        "igdn_f32_192_backward": 6, "gdn_backward_reduce_192": 12}
    assert {rows_: count for ((variant, rows_), count) in gdn_kernel.LAUNCH_ROWS.items()
            if variant == "gdn_f32_192"} == {131072: 2, 32768: 2, 8192: 2}
    assert epoch_graph.CAPTURES[captures]["marks"] == (
        ("step", "forward", "entropy", "context", "synthesis", "backward")
        + ("gdn_backward_begin", "gdn_backward_end") * 6 + ("optimizer", "step_end"))
    phases = fns["train_epoch"].phase_ms()
    assert 0 < phases["context"] < phases["forward"] and 0 < phases["entropy"]
    eager = epoch_graph.epoch_over_rows(fns["train_step"], _state(params), dataset, rows,
                                        torch.Generator("cuda").manual_seed(17))
    plain.plain_fp32()
    ref = plain.State(params)
    noise = torch.Generator("cuda").manual_seed(17)
    for step_rows in rows:
        ref.step(dataset[torch.as_tensor(step_rows, device="cuda")],
                 plain.draw_noises(noise, batch, side, side, "cuda"), LMBDA)
    for (name, start) in params.items():
        expected = torch.linalg.vector_norm(ref.params[name] - start)
        for other in (graphed, eager):
            gap = torch.linalg.vector_norm(steps.params_of(other, mb)[name] - ref.params[name])
            assert float(gap) <= 0.01 * float(expected), name
