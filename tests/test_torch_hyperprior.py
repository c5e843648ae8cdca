"""The scale hyperprior (``models/hyperprior.py``, ``train/hyperprior.py``)
against its plain reference (``models/hyperprior_plain.py``), on the CPU
at the published widths (N = 128, M = 192) on two RGB images of 64 x 64
with seeded random weights; the benchmark's frozen copy of the
reference, its reader of the ``entropy`` phase, and the command line.
The ``cuda``-marked test runs the graphed step on the card (``-m cuda
--noconftest``: this file imports no JAX).

Tolerances: both sides compute in fp32 and differ only in the order of
their sums (the program's NHWC convs, its GDN through ``x^2 @ gamma^T``
and its one pass over both sides of the density's intervals, against
NCHW convs, an einsum and two passes), about 1e-6 of a value: 1e-5
relative on a likelihood, a rate or a loss, and 1e-4 of a leaf's
largest entry on a gradient. Adam's first steps move each entry by
about the rate 1e-4 whatever its gradient, so an entry whose gradient
is rounding alone may move the other way: after three steps a leaf's
change is held within 1 % of the reference's change in norm.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.cli import train_hyperprior as cli
from autoencoder_based_image_compression_tpu_torch.models import hyperprior as hp
from autoencoder_based_image_compression_tpu_torch.models import hyperprior_plain as plain
from autoencoder_based_image_compression_tpu_torch.ops import entropy_models as em
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.train import epoch_graph
from autoencoder_based_image_compression_tpu_torch.train import hyperprior as hyperprior_step
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import load_checkpoint
from autoencoder_based_image_compression_tpu_torch.train.hyperprior import (
    HyperpriorState,
    init_hyperprior_state,
    make_hyperprior_step_fns,
    params_of,
)
from autoencoder_based_image_compression_tpu_torch.train.loop import run_epoch_training
from autoencoder_based_image_compression_tpu_torch.train.state import (
    adam_apply,
    init_adam,
    state_leaves,
)
from autoencoder_based_image_compression_tpu_torch.utils import tracing
from codec_bench import harness, trace
from codec_bench.reference import hyperprior as frozen

LMBDA = 0.01
(BATCH, SIDE) = (2, 64)


def _weights(seed, device="cpu"):
    """Seeded random parameters: the initial ones, with every GDN variable
    and the density drawn at random (a gamma far from symmetric)."""
    generator = torch.Generator().manual_seed(seed)
    params = hp.init_hyperprior_params(generator)
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
    return hyperprior_step.state_of({name: value.clone() for (name, value) in params.items()})


def _close(got, expected, rtol):
    assert float(abs(got - expected)) <= rtol * float(abs(expected)), (float(got),
                                                                       float(expected))


def test_forward_likelihoods_rate_and_gradients_match_the_reference():
    params = _weights(1)
    assert all(float((params[f"{t}_gamma{i}"] - params[f"{t}_gamma{i}"].t()).abs().max()) > 1e-2
               for (t, i) in hp.GDN_SITES)
    batch = _batch(2)
    (noise_y, noise_z) = _noises(3)
    images = batch.float() / 255.0
    x = plain.nchw(images)
    y = hp.analysis(params, images)
    torch.testing.assert_close(plain.nchw(y), plain.analysis(params, x), rtol=1e-5, atol=1e-5)
    (y_tilde, z_tilde) = (y + noise_y, hp.hyper_analysis(params, y) + noise_z)
    lik_z = em.factorized_likelihood(hp.density_params(params), z_tilde)
    lik_y = em.gaussian_likelihood(y_tilde, hp.hyper_synthesis(params, z_tilde))
    ref_z = plain.factorized_likelihood(params, plain.nchw(z_tilde))
    ref_y = plain.gaussian_likelihood(plain.nchw(y_tilde),
                                      plain.hyper_synthesis(params, plain.nchw(z_tilde)))
    torch.testing.assert_close(plain.nchw(lik_z), ref_z, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(plain.nchw(lik_y), ref_y, rtol=1e-5, atol=1e-9)

    leaves = {name: value.clone().requires_grad_(True) for (name, value) in params.items()}
    (loss, parts) = hp.rd_loss(leaves, images, (noise_y, noise_z), LMBDA)
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
    assert set(grads) == set(ref_grads) and len(grads) == 51
    for (name, expected) in ref_grads.items():
        assert float(expected.abs().max()) > 0, name
        torch.testing.assert_close(grads[name], expected, rtol=1e-4,
                                   atol=1e-4 * float(expected.abs().max()), msg=name)


def test_three_steps_through_train_epoch_match_three_reference_steps():
    params = _weights(4)
    dataset = _batch(5, nb=3 * BATCH)
    fns = make_hyperprior_step_fns(LMBDA)
    rows = numpy.arange(3 * BATCH).reshape(3, BATCH)
    got = run_epoch_training(dataset, _state(params), fns, BATCH, 3,
                             torch.Generator().manual_seed(6), permutation=rows.reshape(-1))
    assert int(got.step) == 3 and int(got.opt.count) == 3
    ref = plain.State(params)
    generator = torch.Generator().manual_seed(6)
    for step_rows in rows:
        ref.step(dataset[torch.as_tensor(step_rows)], plain.draw_noises(
            generator, BATCH, SIDE, SIDE, "cpu"), LMBDA)
    for (name, start) in params.items():
        (change, ref_change) = (params_of(got)[name] - start, ref.params[name] - start)
        assert float(torch.linalg.vector_norm(change - ref_change)) <= 0.01 * float(
            torch.linalg.vector_norm(ref_change)), name


def test_adam_over_the_concatenated_leaves_equals_adam_leaf_by_leaf():
    """Two steps on the state's one vector give, bit for bit, what the
    gradients of the named leaves and Adam leaf by leaf give."""
    params = _weights(21)
    step = make_hyperprior_step_fns(LMBDA)["train_step"]
    (flat, by_leaf) = (_state(params), (params, init_adam(params)))
    for seed in (22, 23):
        (batch, noises) = (_batch(seed), _noises(seed + 10))
        flat = step(flat, batch, noises)
        leaves = {name: value.detach().requires_grad_(True)
                  for (name, value) in by_leaf[0].items()}
        (loss, _) = hp.rd_loss(leaves, batch.float() / 255.0, noises, LMBDA)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        by_leaf = adam_apply(grads, by_leaf[1], by_leaf[0], hyperprior_step.LR)
    assert int(flat.opt.count) == int(by_leaf[1].count) == 2
    for (got, expected) in ((params_of(flat), by_leaf[0]),
                            (hyperprior_step.first_moment(flat), by_leaf[1].mu)):
        assert list(got) == list(expected)
        for name in expected:
            assert torch.equal(got[name], expected[name]), name


def test_the_state_takes_only_the_model_parameters():
    params = _weights(24)
    state = _state(params)
    assert state.params["all"].shape == state.opt.mu["all"].shape == (hyperprior_step.SIZE,)
    # Every leaf on a 256-byte boundary; the gaps between them hold 0.
    views = params_of(state)
    assert all(view.storage_offset() % 64 == 0 for view in views.values())
    assert float(state.params["all"].abs().sum()) == pytest.approx(
        sum(float(value.abs().sum()) for value in params.values()), rel=1e-6)
    assert all(torch.equal(params_of(state)[name], value) for (name, value) in params.items())
    for wrong in ({name: value for (name, value) in params.items() if name != "ha_b1"},
                  {**params, "ha_b1": params["ha_b1"][:-1]}):
        with pytest.raises(ValueError, match="names and shapes"):
            hyperprior_step.state_of(wrong)


def test_evaluation_matches_the_reference():
    params = _weights(7)
    batch = _batch(8)
    got = make_hyperprior_step_fns(LMBDA)["evaluation"](_state(params), batch)
    expected = plain.evaluate(params, batch, LMBDA)
    for name in ("bpp", "mse", "psnr", "loss"):
        _close(got[name], expected[name], 1e-5)
    _close(got["bpp_y"] + got["bpp_z"], expected["bpp"], 1e-5)


def test_the_step_marks_its_phases_in_order():
    fns = make_hyperprior_step_fns(LMBDA)
    state = _state(_weights(9))
    dataset = _batch(10)
    program = epoch_graph.EpochProgram(fns["train_step"], state, dataset,
                                       torch.arange(BATCH).reshape(1, BATCH),
                                       torch.Generator().manual_seed(1))
    program.load(state, dataset, torch.arange(BATCH).reshape(1, BATCH), None)
    recorder = tracing.Recorder()
    with tracing.recording(recorder):
        program.step(program.buffers, program.counter)
    assert recorder.names == (["step", "forward", "entropy", "synthesis", "backward"]
                              + ["gdn_backward_begin", "gdn_backward_end"] * 6
                              + ["optimizer", "step_end"])
    stamps = 1000 * numpy.cumsum(numpy.ones((2, len(recorder.names)), dtype=numpy.int64),
                                 axis=1)
    assert epoch_graph.phase_ms(recorder.names, stamps) == pytest.approx(
        {"gather": 1e-3, "forward": 3e-3, "backward": 13e-3, "optimizer": 1e-3,
         "gdn_backward": 6e-3, "entropy": 1e-3, "step": 18e-3})


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


def _kernel(name, start, end):
    return (name, float(start), float(end))


def _steps(nb, entropy_us, synthesis_us):
    """Device events of ``nb`` steps of 1000 us: the marks, a conv."""
    events = []
    for i in range(nb):
        t = 1000.0 * i
        for (mark, offset) in (("step", 0), ("forward", 10), ("entropy", 10 + entropy_us),
                               ("synthesis", 10 + synthesis_us), ("backward", 500),
                               ("optimizer", 900), ("step_end", 990)):
            events.append(_kernel(f"aeic_mark_{mark}", t + offset, t + offset + 1))
        events.append(_kernel("sm90_xmma_fprop_implicit_gemm", t + 20, t + 480))
    return events


def test_the_entropy_reader_on_a_small_synthetic_trace():
    reader = harness.Registry().reader("entropy_ms_per_mpix.train")
    window = [("codec_bench.window", 0.0, 3000.0)]
    run = harness.Run(trace=trace.Trace(_steps(3, 100, 140), window), traced={"mpix": 2.0})
    assert reader.read(run) == pytest.approx(1e-3 * 3 * 40 / 2.0)
    # A step cut by the window's end counts nothing; a step without the
    # forward's marks (the EAE's) reads None; so does a run without a trace.
    cut = trace.Trace(_steps(3, 100, 140), [("codec_bench.window", 0.0, 2500.0)])
    assert reader.read(harness.Run(trace=cut, traced={"mpix": 2.0})) == pytest.approx(
        1e-3 * 2 * 40 / 2.0)
    eae = [event for event in _steps(2, 100, 140) if "entropy" not in event[0]
           and "synthesis" not in event[0]]
    assert reader.read(harness.Run(trace=trace.Trace(eae, window), traced={"mpix": 2.0})) is None
    assert reader.read(harness.Run()) is None


def test_one_epoch_of_the_command_line_saves_a_checkpoint_that_loads_back(tmp_path):
    crops = _batch(14, nb=4).numpy()
    numpy.save(tmp_path / "crops.npy", crops)
    root = str(tmp_path / "results")
    state = cli.main(["--path_to_training_data", str(tmp_path / "crops.npy"), "--batch_size",
                      "2", "--results_root", root, "--device", "cpu"])
    path = os.path.join(root, "lambda_0dot01", "model")
    with open(path + ".json") as file:
        meta = json.load(file)
    assert meta["part_complete"] and meta["step"] == 2
    template = init_hyperprior_state(torch.Generator().manual_seed(99), "cpu")
    loaded = load_checkpoint(path, template)
    assert isinstance(loaded, HyperpriorState)
    for (a, b) in zip(state_leaves(loaded), state_leaves(state), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="refusing to overwrite"):
        cli.main(["--path_to_training_data", str(tmp_path / "crops.npy"), "--batch_size", "2",
                  "--results_root", root, "--device", "cpu"])


@pytest.mark.cuda
def test_cuda_graphed_epoch_against_the_eager_step_and_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the GDN kernel)")
    params = _weights(15, "cuda")
    (batch, side) = (8, 256)
    generator = torch.Generator().manual_seed(16)
    dataset = torch.randint(0, 256, (3 * batch, side, side, 3), dtype=torch.uint8,
                            generator=generator).cuda()
    rows = numpy.arange(3 * batch).reshape(3, batch)
    fns = make_hyperprior_step_fns(LMBDA)
    gdn_kernel.reset_launch_counts()
    captures = len(epoch_graph.CAPTURES)
    graphed = fns["train_epoch"](_state(params), dataset, rows,
                                 torch.Generator("cuda").manual_seed(17))
    # Two steps' launches a capture (the warm-up and the capture), none a replay.
    assert gdn_kernel.LAUNCHES["gdn_f32"] == 6 and gdn_kernel.LAUNCHES["igdn_f32"] == 6
    assert {rows_: count for ((variant, rows_), count) in gdn_kernel.LAUNCH_ROWS.items()
            if variant == "gdn_f32"} == {131072: 2, 32768: 2, 8192: 2}
    # Every site's backward through the gradient kernel.
    assert (gdn_kernel.LAUNCHES["gdn_f32_backward"] == 6
            and gdn_kernel.LAUNCHES["igdn_f32_backward"] == 6
            and gdn_kernel.LAUNCHES["gdn_backward_reduce"] == 12)
    capture = epoch_graph.CAPTURES[captures]
    assert capture["marks"] == (("step", "forward", "entropy", "synthesis", "backward")
                                + ("gdn_backward_begin", "gdn_backward_end") * 6
                                + ("optimizer", "step_end"))
    phases = fns["train_epoch"].phase_ms()
    assert set(phases) == {"gather", "forward", "backward", "optimizer", "gdn_backward",
                           "entropy", "step"}
    assert 0 < phases["entropy"] < phases["forward"]
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
            gap = torch.linalg.vector_norm(params_of(other)[name] - ref.params[name])
            assert float(gap) <= 0.01 * float(expected), name
