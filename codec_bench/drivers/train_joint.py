"""Training Minnen et al.'s joint autoregressive and hierarchical prior
through graphed epochs (``configs/minnen2018_joint.json``), after
``drivers/train_hyperprior.py``, whose crops and comparison it shares.

Set-up imports the program's model first (a checkout without it fails
at once), makes a device-resident pool of RGB crops from ``--seed``
(three synthetic luminance draws stacked as the channels) and the
initial weights (the configuration's ``assumed`` distributions, drawn on
the card), builds the program's state on those weights and drives it
through its first three steps with the window's own call
(``train/loop.py::run_epoch_training`` over the graphed epoch of the
program's ``train_step`` for this model): one epoch of three batches on
rows that all differ, whose state the window goes on from; the first
step alone, for the gradient Adam got, is a one-batch epoch from the
same initial state with a generator seeded alike. One whole epoch more
captures the window's graph; the window then runs whole epochs back to
back until ``--seconds`` have passed. Once it has closed, the plain
reference (``reference/minnen2018.py``) follows the three steps from the
same weights, batches and noise (a generator seeded as the program's,
``y``'s noise then ``z``'s each step) and the two are compared leaf by
leaf, every one of the 59 leaves, as the hyperprior's driver compares
its own:

- ``grad_gap``: the first step's gradient as Adam got it (its first
  moment over 0.1): the gap between the program's norm and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf.
- ``change_gap``: the same of each leaf's change over the three steps.

With ``--trace 1`` the traced steps' work holds ``gdn_bound_s`` and
``gdn_backward_bound_s``, the least time of their GDN launches and of
their gradients at 192 channels (``roofline_minnen2018.py``).
"""

import contextlib
import math
import os
import time

import numpy
import torch

from codec_bench import harness, roofline_minnen2018, trace, training
from codec_bench.reference import minnen2018 as reference
from codec_bench.reference import plain_fp32, tf32

_HYPERPRIOR = harness._load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_hyperprior.py"),
    "codec_bench_driver_train_hyperprior")
(CHECK_STEPS, ADAM_B1) = (_HYPERPRIOR.CHECK_STEPS, _HYPERPRIOR.ADAM_B1)
(rgb_crops, leaf_gaps, compare) = (_HYPERPRIOR.rgb_crops, _HYPERPRIOR.leaf_gaps,
                                   _HYPERPRIOR.compare)
reference_readings = _HYPERPRIOR.reference_readings


def _program():
    """The program's modules this cell runs: ``(model, steps, loop)``."""
    from autoencoder_based_image_compression_tpu_torch.models import minnen2018
    from autoencoder_based_image_compression_tpu_torch.train import hyperprior as steps
    from autoencoder_based_image_compression_tpu_torch.train import loop

    return (minnen2018, steps, loop)


def initial_weights(generator, config, device):
    """The program's initial parameters (``models/minnen2018.py``'s names
    and layouts), from ``generator`` in two draws: every conv kernel
    N(0, 1 / (in * k * k)) (the context model's masked taps too), zero
    biases, GDN ``beta = 1`` and ``gamma = 0.1 I`` as their stored
    variables, the factorized density's matrices at the scale 10, its
    biases U(-1/2, 1/2) and its factors 0."""
    gdn = config["gdn"]
    pedestal = gdn["reparam_offset"] ** 2
    filters = (1,) + tuple(config["filters"]) + (1,)
    n = config["N"]
    context = (config["kernel_context"], config["kernel_context"])

    def shape(name, kind, nb_in, nb_out, taps):
        kernel = context if name == "cm_w" else (math.isqrt(taps),) * 2
        return (((nb_out, nb_in) if kind == "conv" else (nb_in, nb_out)) + kernel)

    layers = [(name, kind, nb_in, nb_out, shape(name, kind, nb_in, nb_out, taps))
              for (name, kind, _, nb_in, nb_out, taps, _) in roofline_minnen2018.LAYERS]
    sizes = [math.prod(s) for (_, _, _, _, s) in layers]
    normal = torch.randn((sum(sizes),), generator=generator, device=device)
    weights = {}
    for ((name, _, nb_in, nb_out, s), part) in zip(layers, torch.split(normal, sizes)):
        weights[name] = part.reshape(s) / math.sqrt(nb_in * s[-1] * s[-2])
        weights[name.replace("_w", "_b")] = torch.zeros((nb_out,), device=device)
    for transform in ("ga", "gs"):
        for i in (1, 2, 3):
            weights[f"{transform}_beta{i}"] = torch.sqrt(
                gdn["beta_init"] * torch.ones((n,), device=device) + pedestal)
            weights[f"{transform}_gamma{i}"] = torch.sqrt(
                gdn["gamma_init"] * torch.eye(n, device=device) + pedestal)
    nb_layers = len(filters) - 1
    biases = torch.rand((n, sum(filters[1:])), generator=generator, device=device) - 0.5
    scale = config["init_scale"] ** (1.0 / nb_layers)
    for (i, bias) in enumerate(torch.split(biases, list(filters[1:]), dim=1)):
        init = math.log(math.expm1(1.0 / scale / filters[i + 1]))
        weights[f"fd_matrix_{i}"] = torch.full((n, filters[i + 1], filters[i]), init,
                                               device=device)
        weights[f"fd_bias_{i}"] = bias.reshape(n, filters[i + 1], 1).contiguous()
        if i < nb_layers - 1:
            weights[f"fd_factor_{i}"] = torch.zeros((n, filters[i + 1], 1), device=device)
    return {name: value.contiguous() for (name, value) in weights.items()}


def program_readings(first, third):
    """``(gradient, params)``: the first step's gradient as Adam got it
    (the program's first moment of each leaf over 0.1) and the
    parameters after step 3."""
    (model, steps, _) = _program()
    moments = steps.first_moment(first, model)
    return ({name: mu / (1.0 - ADAM_B1) for (name, mu) in moments.items()},
            steps.params_of(third, model))


class Prepared:
    """The cell up to its window: the crops, the weights, the program's
    step functions and state after the check steps, and what the
    reference needs to follow them."""

    def __init__(self, context, fault=None):
        (model, steps, loop) = _program()
        (config, traffic) = (context.config, context.traffic)
        self.config = config
        self.lmbda = config["training"]["lmbda"]
        self.device = torch.device(context.device)
        (self.batch, self.crop, self.nb_crops) = (traffic["batch_size"], traffic["crop"],
                                                  traffic["crops"])
        self.nb_batches = self.nb_crops // self.batch
        seed = context.seed % 2 ** 63
        generator = torch.Generator(self.device).manual_seed(seed)
        self.crops = rgb_crops(self.nb_crops, self.crop, generator, self.device)
        self.weights = initial_weights(generator, config, self.device)
        self.noise_seed = (seed + 1) % 2 ** 63
        self.noise = torch.Generator(self.device).manual_seed(self.noise_seed)
        self.shuffle = numpy.random.default_rng(seed)
        self.run_epoch = loop.run_epoch_training
        self.step_fns = steps.make_hyperprior_step_fns(self.lmbda, model)
        if fault is not None:
            self.step_fns = fault(self.step_fns)
        start = steps.state_of({name: value.clone() for (name, value) in self.weights.items()},
                               model)
        self.rows = self.shuffle.permutation(self.nb_crops)[:CHECK_STEPS * self.batch].reshape(
            CHECK_STEPS, self.batch)
        first = self.epoch(start, 1, self.rows[0],
                           torch.Generator(self.device).manual_seed(self.noise_seed))
        self.state = self.epoch(start, CHECK_STEPS, self.rows.reshape(-1))
        self.readings = program_readings(first, self.state)

    def epoch(self, state, nb_batches, permutation, noise=None):
        """The window's call over ``nb_batches`` batches of the rows
        ``permutation`` gives, drawing from the window's generator unless
        ``noise`` is given."""
        return self.run_epoch(self.crops, state, self.step_fns, self.batch, nb_batches,
                              self.noise if noise is None else noise, permutation=permutation)

    def reference(self, precision=plain_fp32):
        """The reference's state after its :data:`CHECK_STEPS` steps;
        ``precision`` sets the card's fp32 switches first (the control
        passes TF32 on)."""
        state = reference.State(self.weights, precision)
        generator = torch.Generator(self.device).manual_seed(self.noise_seed)
        for step_rows in self.rows:
            images = self.crops[torch.as_tensor(step_rows, device=self.crops.device)]
            noises = reference.draw_noises(generator, self.batch, self.crop, self.crop,
                                           self.device)
            state.step(images, noises, self.lmbda)
        return state


def run(context):
    _program()  # a checkout without the model stops here, before any set-up
    from autoencoder_based_image_compression_tpu_torch.train.state import clone_state

    traffic = context.traffic
    prepared = Prepared(context)
    (device, shuffle, nb_batches) = (prepared.device, prepared.shuffle, prepared.nb_batches)
    # The window's graph: one whole epoch, captured at its first call; then
    # the memory of the state an epoch hands back, so that the window's
    # first epoch does not wait on the allocator.
    state = prepared.epoch(prepared.state, nb_batches, shuffle.permutation(prepared.nb_crops))
    prepared.state = None
    clone_state(state)
    training._synchronize(device)

    result = harness.Run()
    result.setup_s = time.time() - context.started
    (epochs, traced_epochs, paused) = (0, 0, 0.0)
    profile = trace.profiler(context.device) if context.trace else None
    started = time.perf_counter()
    while True:
        permutation = shuffle.permutation(prepared.nb_crops)
        traced = (profile is not None and result.trace is None
                  and time.perf_counter() - started - paused < traffic["trace_seconds"])
        if traced and traced_epochs == 0:
            paused += trace.start(profile)
        with (torch.profiler.record_function(trace.WINDOW_SPAN) if traced
              else contextlib.nullcontext()):
            state = prepared.epoch(state, nb_batches, permutation)
            training._synchronize(device)
        epochs += 1
        traced_epochs += traced
        if traced_epochs and not traced and result.trace is None:
            (result.trace, seconds) = trace.stop(profile)
            paused += seconds
        if time.perf_counter() - started - paused >= context.seconds:
            break
    if traced_epochs and result.trace is None:
        (result.trace, seconds) = trace.stop(profile)
        paused += seconds
    result.window_s = time.perf_counter() - started - paused
    if device.type == "cuda":
        result.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    (batch, crop) = (prepared.batch, prepared.crop)
    steps = epochs * nb_batches
    result.attempted = steps
    finite = all(bool(torch.isfinite(leaf).all()) for leaf in state.params.values())
    result.failed = 0 if finite else steps
    pixels = batch * crop * crop
    result.metrics["train_mpix_per_s"] = steps * pixels / result.window_s / 1e6
    step_flops = batch * roofline_minnen2018.train_flops(crop, crop)
    result.work = {"mpix": steps * pixels / 1e6, "flops": {"fp32": steps * step_flops}}
    traced_steps = traced_epochs * nb_batches
    result.traced = {
        "mpix": traced_steps * pixels / 1e6,
        "gdn_bound_s": traced_steps * roofline_minnen2018.gdn_bound_s(batch, crop, crop),
        "gdn_backward_bound_s": traced_steps * roofline_minnen2018.gdn_backward_bound_s(
            batch, crop, crop)}

    # The window has closed: free the program's state, then the reference.
    del state
    prepared.step_fns = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result.checks = compare(prepared.weights, prepared.readings, prepared.reference())
    return result


def readings(context, kind, faults):
    """The numbers compared after the check steps of a run of ``kind``:
    "sound", "control" (the reference in TF32 in the program's place) or
    a fault of ``faults`` (``codec_bench/calibrate.py::FAULTS``), each
    with the leaf it was read at (``<number>_leaf``)."""
    prepared = Prepared(context, fault=faults.get(kind))
    ref = prepared.reference()
    found = prepared.readings
    if kind == "control":
        found = reference_readings(prepared.reference(tf32))
        plain_fp32()
    numbers = {}
    for (name, gaps) in leaf_gaps(prepared.weights, found, ref).items():
        leaf = max(gaps, key=gaps.get)
        numbers.update({name: gaps[leaf], f"{name}_leaf": leaf})
    return numbers
