"""Training the scale hyperprior (``models/hyperprior.py``) and Minnen et
al.'s joint autoregressive and hierarchical prior
(``models/minnen2018.py``): their state, their step and their
evaluation, written once over the model module (:data:`MODELS`).

The two models differ by their ``param_shapes()``, their initial
parameters and their ``rd_loss`` / ``rate_distortion``; everything below
takes the model module (``model``, the hyperprior by default).

One step on a batch of uint8 RGB crops ``(B, H, W, 3)``: the images go
to [0, 1] in fp32, the rate-distortion loss ``bpp + lambda * 255^2 *
mse`` is differentiated with respect to every parameter (the transforms,
the GDN variables, the factorized density, and Minnen et al.'s context
model and entropy parameters), and one Adam step at the constant rate
1e-4 (``train/state.py::adam_apply``, the EAE's arithmetic) updates them
all. No density phase, no bin widths, no projection: the GDN variables
keep their bounds through their reparameterisation.

The parameters and Adam's moments are each one vector, the model's
leaves (51 of the hyperprior, 59 of Minnen et al.'s) laid end to end in
the order of its ``param_shapes`` (each on a 256-byte boundary)
(``state.params["all"]``, ``opt.mu["all"]``, ``opt.nu["all"]``);
:func:`params_of` and :func:`first_moment` give them by name, as views.
The loss takes the named views of the vector, so the step's gradient
is one vector too and Adam updates it as one leaf: its arithmetic is
elementwise, so that is each leaf's update, in one launch of Adam's
kernel on the card (``ops/kernels/adam_kernel.py``); and a graphed step
writes 5 tensors back into its buffers.

The step is ``(state, batch, noise) -> state``, so ``train_epoch =
epoch_fn(train_step)`` replays one captured step a batch on the card and
runs the eager loop on the CPU (``train/epoch_graph.py``), and
``train/loop.py::run_epoch_training`` drives it as it drives the EAE's.
``noise`` is a ``torch.Generator`` on the state's device, from which
``y``'s noise and then ``z``'s are drawn, or the pair itself.

**Precision**: fp32 with TF32 off in both switches (``disable_tf32``,
at every transform). **Phases**: ``forward`` (the analysis transform,
``y``'s noise), ``entropy``, Minnen et al.'s ``context``, ``synthesis``
(the models' modules), ``backward`` (six ``gdn_backward_*`` pairs
inside), ``optimizer``. A step launches 3 ``gdn_f32`` and 3
``igdn_f32`` at 128 channels (the hyperprior), or 3 ``gdn_f32_192`` and
3 ``igdn_f32_192`` (Minnen et al.'s), each with its backward.
"""

import math
from typing import Dict, NamedTuple

import torch

from autoencoder_based_image_compression_tpu_torch.models import hyperprior, minnen2018
from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn
from autoencoder_based_image_compression_tpu_torch.train.state import (
    AdamState,
    adam_apply,
    init_adam,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase

LR = 1e-4
LMBDA = 0.01
# The models this module trains, by the name the command line gives:
# (module, its initial parameters' function, the default lambda).
MODELS = {"hyperprior": (hyperprior, hyperprior.init_hyperprior_params, LMBDA),
          "minnen2018": (minnen2018, minnen2018.init_params, 0.013)}
# Each leaf starts a multiple of 256 bytes into the vector, as its own
# allocation would (the convs' kernels choose by their operands'
# alignment); the gaps stay 0 under Adam (a zero gradient moves nothing).
ALIGN = 64


def _layout(model):
    """``(shapes, spans, size)`` of ``model``'s vector: ``{name: shape}``,
    each leaf's ``(size, gap after it)``, and the vector's length."""
    shapes = model.param_shapes()
    spans = [(math.prod(shape), -math.prod(shape) % ALIGN) for shape in shapes.values()]
    return (shapes, spans, sum(size + gap for (size, gap) in spans))


_LAYOUTS = {model: _layout(model) for (model, _, _) in MODELS.values()}


def size_of(model=hyperprior):
    """The length of ``model``'s vector."""
    return _LAYOUTS[model][2]


SIZE = size_of(hyperprior)


class HyperpriorState(NamedTuple):
    """Every leaf a tensor on one device (either model's)."""

    params: Dict[str, torch.Tensor]  # {"all": (size,)}: the model's parameters
    opt: AdamState                   # Adam's count, and its moments as {"all": (size,)}
    step: torch.Tensor               # int32 count of the steps made


def leaves(flat, model=hyperprior):
    """The vector ``flat`` cut into the named views of ``model``'s
    parameters."""
    (shapes, spans, _) = _LAYOUTS[model]
    pieces = torch.split(flat, [n for span in spans for n in span])[::2]
    return {name: piece.view(shape) for ((name, shape), piece) in zip(shapes.items(), pieces)}


def state_of(params, model=hyperprior):
    """A fresh state on ``model``'s named parameters ``params`` (zero
    moments, count and step), on their device."""
    (shapes, _, size) = _LAYOUTS[model]
    if {name: tuple(value.shape) for (name, value) in params.items()} != shapes:
        raise ValueError(f"the parameters are not {model.__name__}'s names and shapes.")
    flat = torch.zeros((size,), device=next(iter(params.values())).device)
    for (name, view) in leaves(flat, model).items():
        view.copy_(params[name])
    return HyperpriorState(params={"all": flat}, opt=init_adam({"all": flat}),
                           step=torch.zeros((), dtype=torch.int32, device=flat.device))


def init_hyperprior_state(generator, device="cuda", model=hyperprior):
    """A fresh state of ``model`` on ``device``, its parameters drawn from
    ``generator`` on its own device (one seed, one start on any
    device)."""
    device = resolve_device(device)
    init = next(init for (module, init, _) in MODELS.values() if module is model)
    return state_of({name: value.to(device) for (name, value) in init(generator).items()}, model)


def params_of(state, model=hyperprior):
    """The state's parameters by name (views of its vector)."""
    return leaves(state.params["all"], model)


def first_moment(state, model=hyperprior):
    """Adam's first moment of each leaf, by name (views of the state's)."""
    return leaves(state.opt.mu["all"], model)


def images_of(batch):
    """uint8 crops -> fp32 images in [0, 1], on the device."""
    return batch.to(torch.float32) / 255.0


def make_hyperprior_step_fns(lmbda=LMBDA, model=hyperprior):
    """The step functions of one ``model`` (a module of :data:`MODELS`) at
    the rate-distortion weight ``lmbda``:

    - ``train_step(state, batch, noise)``: one Adam step on the loss;
    - ``train_epoch(state, dataset, rows, noise)``: ``train_step`` over
      the ``(nb_batches, batch_size)`` rows of a device-resident uint8
      dataset (the captured graph's replays on the card);
    - ``evaluation(state, batch)``: with the latents rounded, a dict of
      ``bpp``, ``bpp_y``, ``bpp_z``, ``mse``, ``psnr`` (of the
      reconstruction clipped to [0, 1], dB) and ``loss``, scalar tensors.
    """

    def train_step(state, batch, noise):
        flat = state.params["all"].detach().requires_grad_(True)
        with phase("forward"), torch.enable_grad():
            (loss, _) = model.rd_loss(leaves(flat, model), images_of(batch), noise, lmbda)
        with phase("backward"):
            (grad,) = torch.autograd.grad(loss, [flat])
        with phase("optimizer"), torch.no_grad():
            (params, opt) = adam_apply({"all": grad}, state.opt, state.params, LR)
        return HyperpriorState(params=params, opt=opt, step=state.step + 1)

    @torch.no_grad()
    def evaluation(state, batch):
        images = images_of(batch)
        (loss, parts) = model.rate_distortion(params_of(state, model), images, lmbda,
                                              torch.round, torch.round)
        clipped = torch.clamp(parts["reconstruction"], 0.0, 1.0)
        psnr = -10.0 * torch.log10(torch.mean(torch.square(images - clipped)))
        return {"bpp": parts["bpp"], "bpp_y": parts["bpp_y"], "bpp_z": parts["bpp_z"],
                "mse": parts["mse"], "psnr": psnr, "loss": loss}

    return {"train_step": train_step, "train_epoch": epoch_fn(train_step),
            "evaluation": evaluation}
