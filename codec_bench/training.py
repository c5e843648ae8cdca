"""The training cells: one model, or the gamma ladder as one program.

Set-up makes a device-resident crop set and the initial weights from
``--seed``, builds the program's training state on those weights and
drives it through its first three steps with the window's own call
(``train/loop.py::run_epoch_training`` over the graphed epoch of
``train_step``): one epoch of three batches, on rows that all differ,
so that the replays gather each batch by the epoch's device counter as
the window's do; its state is the one the window goes on from. The
first step alone, for the gradient Adam got and the pdf table, is a
one-batch epoch from the same initial state with a generator seeded
alike. One whole epoch more captures the window's graph. The window
then runs whole epochs back to back, each with its host shuffle, state
copies and a synchronisation at its end, until ``--seconds`` have
passed. Once it has closed, the reference follows the three steps from
the same weights, batches and noise (a generator seeded as the
program's) and the two are compared leaf by leaf:

- ``grad_gap``: the first step's gradient as Adam got it (its first
  moment over 0.1), by leaf: the gap between the program's norm and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf of every model. Leaves whose
  reference gradient is under a thousandth of the median leaf's (nought
  to rounding) are left out, here and in ``change_gap``.
- ``change_gap``: the same of each leaf's change over the three steps.
- ``density_gap``: the same of the pdf table's change in the first step
  (the density phase's SGD step on the initial weights; over three steps
  Adam's sign flips in the later steps' latents swing it), the worst
  model.

The bin widths are left out: their rate, 2e-8, moves them by less than
their own rounding in three steps.
"""

import contextlib
import time

import numpy
import torch

from codec_bench import harness, roofline, synthetic, trace
from codec_bench.reference import plain_fp32
from codec_bench.reference import training as reference

# The conv kernels' shapes in the program's layouts (OIHW for the
# encoder, conv_transpose2d's (in, out, kh, kw) for the decoder) and the
# reference's initial standard deviations (EntropyAutoencoder.py).
KERNELS = {"weights_1": ((128, 1, 9, 9), 0.01), "weights_2": ((128, 128, 5, 5), 0.02),
           "weights_3": ((128, 128, 5, 5), 0.05), "weights_4": ((128, 128, 5, 5), 0.05),
           "weights_5": ((128, 128, 5, 5), 0.02), "weights_6": ((128, 1, 9, 9), 0.01)}
ORDER = ("weights_1", "biases_1", "gamma_1", "beta_1", "weights_2", "biases_2", "gamma_2",
         "beta_2", "weights_3", "biases_3", "weights_4", "biases_4", "gamma_5", "beta_5",
         "weights_5", "biases_5", "gamma_6", "beta_6", "weights_6", "gamma_3", "beta_3",
         "gamma_4", "beta_4")
GDN_MIN = 2e-5
GDN_MAX = 0.01
CHECK_STEPS = 3


def initial_weights(generator, learn_bin_widths, models, device):
    """The initial parameters of ``models`` models, each leaf ``(models,
    ...)``, drawn on the device in two calls: conv kernels N(0, std),
    zero biases, GDN gammas U(2e-5, 0.01) made symmetric, unit betas."""
    gdn = [1, 2, 5, 6] if learn_bin_widths else [1, 2, 3, 4, 5, 6]
    sizes = [int(numpy.prod(shape)) for (shape, _) in KERNELS.values()]
    normal = torch.randn((models, sum(sizes)), generator=generator, device=device)
    uniform = torch.rand((models, len(gdn), 128, 128), generator=generator, device=device)
    weights = {}
    for ((name, (shape, std)), part) in zip(KERNELS.items(),
                                           torch.split(normal, sizes, dim=1)):
        weights[name] = std * part.reshape(models, *shape)
    for i in range(1, 6):
        weights[f"biases_{i}"] = torch.zeros((models, 128), device=device)
    for (j, i) in enumerate(gdn):
        raw = GDN_MIN + (GDN_MAX - GDN_MIN) * uniform[:, j]
        weights[f"gamma_{i}"] = 0.5 * (raw + raw.transpose(1, 2))
        weights[f"beta_{i}"] = torch.ones((models, 128), device=device)
    return {name: weights[name].contiguous() for name in ORDER if name in weights}


def _program_state(weights, bin_width, ladder):
    """The program's training state on the benchmark's weights."""
    from autoencoder_based_image_compression_tpu_torch.ops.density import init_density_table
    from autoencoder_based_image_compression_tpu_torch.train.ladder import ladder_stack_states
    from autoencoder_based_image_compression_tpu_torch.train.state import TrainState, init_adam

    def one(m):
        params = {name: value[m].clone() for (name, value) in weights.items()}
        device = params["weights_1"].device
        return TrainState(params=params,
                          density=init_density_table(128, device=device),
                          bin_widths=torch.full((128,), float(bin_width), device=device),
                          opt_eae=init_adam(params),
                          step=torch.zeros((), dtype=torch.int32, device=device))

    models = next(iter(weights.values())).shape[0]
    return ladder_stack_states([one(m) for m in range(models)]) if ladder else one(0)


def program_readings(first, third, ladder):
    """``[(gradient, params, table)]`` a model: the first step's gradient
    as Adam got it (its first moment over 0.1) and the pdf table from the
    state after step 1, the parameters after step 3."""
    def leaves(state, m):
        pick = (lambda v: v[m]) if ladder else (lambda v: v)
        return ({k: pick(v) for (k, v) in state.params.items()},
                {k: pick(v) for (k, v) in state.opt_eae.mu.items()},
                pick(state.density.parameters))

    models = first.step.shape[0] if ladder else 1
    readings = []
    for m in range(models):
        (_, mu, table) = leaves(first, m)
        (params, _, _) = leaves(third, m)
        readings.append(({k: v / (1.0 - reference.ADAM[0]) for (k, v) in mu.items()},
                         params, table))
    return readings


def reference_readings(states):
    """:func:`program_readings` of reference states (the control)."""
    return [(state.first_gradient, state.params, state.first_table) for state in states]


def _norm(tensor):
    return float(torch.linalg.vector_norm(tensor.detach().to(torch.float64)))


def _gaps(program, reference_norms):
    """``{leaf: gap}`` of norms, over the reference's norm of the leaf or
    of the median leaf, whichever is larger."""
    median = float(numpy.median(list(reference_norms.values())))
    return {name: abs(program[name] - value) / max(value, median)
            for (name, value) in reference_norms.items()}


def compare(weights, readings, references):
    """The numbers compared (see the module docstring): ``readings`` of
    :func:`program_readings`, ``references`` the reference's
    :class:`reference.State` of each model after step 3, both from
    ``weights``."""
    (grad_gap, change_gap, density_gap) = (0.0, 0.0, 0.0)
    for (m, (ref, (gradient, params, table))) in enumerate(zip(references, readings)):
        expected = {name: _norm(grad) for (name, grad) in ref.first_gradient.items()}
        median = float(numpy.median(list(expected.values())))
        counted = [name for (name, value) in expected.items() if value >= 1e-3 * median]
        got = {name: _norm(gradient[name]) for name in counted}
        grad_gap = max(grad_gap, max(_gaps(got, {n: expected[n] for n in counted}).values()))
        start = {name: weights[name][m] for name in counted}
        program_change = {name: _norm(params[name] - start[name]) for name in counted}
        reference_change = {name: _norm(ref.params[name] - start[name]) for name in counted}
        change_gap = max(change_gap, max(_gaps(program_change, reference_change).values()))
        (table_start, _) = reference.initial_table(table.shape[0], table.device)
        program_table = _norm(table - table_start)
        reference_table = _norm(ref.first_table - table_start)
        density_gap = max(density_gap, abs(program_table - reference_table) / reference_table)
    return {"grad_gap": grad_gap, "change_gap": change_gap, "density_gap": density_gap}


def reference_steps(weights, crops, rows, noise_seed, config, ladder, device,
                    precision=plain_fp32):
    """The reference's first :data:`CHECK_STEPS` steps of each model, with
    the program's batches and noise: a generator seeded as the
    program's, drawn in its order (a model's latents' shape, or ``(M,
    ...)`` at once for the ladder; the density phase first). ``precision``
    sets the card's fp32 switches first (the control passes TF32 on)."""
    precision()
    training = config["training"]
    gammas = training["gammas"] if ladder else [training["gamma"]]
    models = len(gammas)
    states = [reference.State({name: value[m] for (name, value) in weights.items()},
                              training["bin_width_init"], config["learn_bin_widths"])
              for m in range(models)]
    generator = torch.Generator(device).manual_seed(noise_seed)
    (batch, height, width, _) = (len(rows[0]),) + tuple(crops.shape[1:])
    latent = (batch, height // 16, width // 16, 128)
    for step_rows in rows[:CHECK_STEPS]:
        images = crops[torch.as_tensor(step_rows, device=crops.device)]
        shape = ((models,) + latent) if ladder else latent
        draws = [torch.rand(shape, generator=generator, device=device) - 0.5 for _ in range(2)]
        for (m, state) in enumerate(states):
            noises = [draw[m] for draw in draws] if ladder else draws
            state.step(images, noises, gammas[m])
    return states


class Prepared:
    """A training cell up to its window: the crop set, the weights, the
    program's step functions and state after the check steps, and what
    the reference needs to follow them."""

    def __init__(self, context, ladder, fault=None):
        from autoencoder_based_image_compression_tpu_torch.train import loop
        from autoencoder_based_image_compression_tpu_torch.train.ladder import (
            make_ladder_step_fns,
        )
        from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns

        (config, traffic) = (context.config, context.traffic)
        training = config["training"]
        self.ladder = ladder
        self.learn = config["learn_bin_widths"]
        self.gammas = training["gammas"] if ladder else [training["gamma"]]
        self.device = torch.device(context.device)
        (self.batch, self.crop, self.nb_crops) = (traffic["batch_size"], traffic["crop"],
                                                  traffic["crops"])
        self.nb_batches = self.nb_crops // self.batch
        seed = context.seed % 2 ** 63
        generator = torch.Generator(self.device).manual_seed(seed)
        self.crops = synthetic.luminance_stack(self.nb_crops, self.crop, self.crop, generator,
                                               self.device)
        self.weights = initial_weights(generator, self.learn, len(self.gammas), self.device)
        self.noise_seed = (seed + 1) % 2 ** 63
        self.noise = torch.Generator(self.device).manual_seed(self.noise_seed)
        self.shuffle = numpy.random.default_rng(seed)
        self.run_epoch = loop.run_epoch_training
        self.step_fns = (make_ladder_step_fns(self.gammas) if ladder
                         else make_step_fns(self.gammas[0], self.learn))
        if fault is not None:
            self.step_fns = fault(self.step_fns)
        start = _program_state(self.weights, training["bin_width_init"], ladder)
        self.rows = self.shuffle.permutation(self.nb_crops)[:CHECK_STEPS * self.batch].reshape(
            CHECK_STEPS, self.batch)
        first = self.epoch(start, 1, self.rows[0],
                           torch.Generator(self.device).manual_seed(self.noise_seed))
        self.state = self.epoch(start, CHECK_STEPS, self.rows.reshape(-1))
        self.readings = program_readings(first, self.state, ladder)

    def epoch(self, state, nb_batches, permutation, noise=None):
        """The window's call: the program's epoch over ``nb_batches``
        batches of the rows ``permutation`` gives, drawing its noise from
        the window's generator unless ``noise`` is given."""
        return self.run_epoch(self.crops, state, self.step_fns, self.batch, nb_batches,
                              self.noise if noise is None else noise, permutation=permutation)

    def references(self, config, precision=plain_fp32):
        return reference_steps(self.weights, self.crops, self.rows, self.noise_seed, config,
                               self.ladder, self.device, precision)


def run(context, ladder):
    """A training cell's run (see the module docstring); ``ladder``: every
    model of the configuration's gammas as one stacked program."""
    from autoencoder_based_image_compression_tpu_torch.train.state import clone_state

    traffic = context.traffic
    prepared = Prepared(context, ladder)
    (device, shuffle, nb_batches) = (prepared.device, prepared.shuffle, prepared.nb_batches)
    # The window's graph: one whole epoch, captured at its first call. Then
    # the memory of the state an epoch hands back, so that the window's
    # first epoch does not wait on the allocator (seen to stall 2 s).
    state = prepared.epoch(prepared.state, nb_batches, shuffle.permutation(prepared.nb_crops))
    prepared.state = None
    clone_state(state)  # freed at once: the allocator keeps its blocks for the window
    _synchronize(device)

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
            _synchronize(device)
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

    (batch, crop, models) = (prepared.batch, prepared.crop, len(prepared.gammas))
    steps = epochs * nb_batches
    result.attempted = steps
    finite = all(bool(torch.isfinite(leaf).all()) for leaf in state.params.values())
    result.failed = 0 if finite else steps
    pixels = batch * crop * crop * models
    result.metrics["train_mpix_per_s"] = steps * pixels / result.window_s / 1e6
    step_flops = batch * models * roofline.train_flops(crop, crop, prepared.learn)
    result.work = {"mpix": steps * pixels / 1e6, "flops": {"fp32": steps * step_flops}}
    traced_steps = traced_epochs * nb_batches
    result.traced = {"mpix": traced_steps * pixels / 1e6,
                     "gdn_bound_s": traced_steps * roofline.gdn_sites_bound_s(
                         roofline.train_gdn_sites(prepared.learn, batch, crop, crop, models))}

    # The window has closed: free the program's state, then the reference.
    del state
    prepared.step_fns = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result.checks = compare(prepared.weights, prepared.readings,
                            prepared.references(context.config))
    return result


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)

