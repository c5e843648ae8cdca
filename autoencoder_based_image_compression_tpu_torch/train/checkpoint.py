"""Checkpoints and params artifacts, in the reference's formats on disk.

A checkpoint is ``<path>.npz`` plus a ``<path>.json`` sidecar written
last; a params artifact is one compressed ``params_trained.npz`` with
``param:<name>`` arrays, ``bin_widths`` and ``step``. Both use the key
scheme and the layouts of the reference package, so a file written by
either package loads in the other:

- a checkpoint's leaves are keyed by their path in the reference's
  state, e.g. ``.params['gamma_1']``, ``.density.parameters``,
  ``.opt_eae[0].mu['weights_1']``, ``.step``. The reference's optimiser
  is a chain of two transformations that each count the updates
  (``.opt_eae[0].count`` and ``.opt_eae[1].count``): this package keeps
  one count and writes it under both keys;
- conv kernels, *and their Adam moments*, are permuted back to the
  reference's HWIO on save (:func:`params_to_jax`) and to this package's
  layouts on load (:func:`params_from_jax`).

The SVHN side's states, :class:`DenseEaeState` and :class:`VaeState`,
take the same way under the reference's keys (``.params['we_l1']``,
``.momentum['we_l1']``, ``.density.parameters``, ``.bin_width``,
``.step``); their dense weights are ``(in, out)`` in both packages and
carry across unchanged. A VAE has no density, so its sidecar says
``"nb_itvs_per_side": null``; the reference package loads such a
checkpoint, although its own VAE trainer fails to write one.

The scale hyperprior's :class:`HyperpriorState`, which Minnen et al.'s
joint prior shares, has no counterpart in the reference package; it is
written under the same scheme (``.params['all']``, ``.opt.count``,
``.opt.mu['all']``, ``.opt.nu['all']``, ``.step``: its parameters and
Adam moments are one vector each, which ``train/hyperprior.py::leaves``
cuts into the named leaves), its kernels in this package's layouts.

Many leaves share a shape (all GDN gammas are (128, 128)), so a renamed,
missing, extra or reshaped key raises at load instead of mapping onto
another tensor. An existing checkpoint is not overwritten unless asked.
"""

import json
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.constants import CONV_NAMES
from autoencoder_based_image_compression_tpu_torch.models.dense_eae import DenseEaeState
from autoencoder_based_image_compression_tpu_torch.models.vae import VaeState
from autoencoder_based_image_compression_tpu_torch.ops.density import DensityTable
from autoencoder_based_image_compression_tpu_torch.train.hyperprior import (
    MODELS as HYPERPRIOR_MODELS,
    HyperpriorState,
    size_of,
)
from autoencoder_based_image_compression_tpu_torch.train.state import (
    AdamState,
    TrainState,
    state_to,
)


def load_params_artifact(path_npz):
    """Loads a params artifact.

    Returns ``(params, bin_widths)``: a dict of numpy arrays in the
    reference's layouts and the float32 bin widths.
    """
    with numpy.load(path_npz) as data:
        params = {key[len("param:"):]: numpy.asarray(data[key])
                  for key in data.files if key.startswith("param:")}
        bin_widths = numpy.asarray(data["bin_widths"], numpy.float32)
    return (params, bin_widths)


def params_from_jax(params_np):
    """Reference-layout numpy params -> dict of float32 CPU tensors.

    - Encoder kernels are HWIO; ``permute(3, 2, 0, 1)`` gives OIHW.
    - Decoder kernels are stored ``(kh, kw, tconv_out, tconv_in)``, the
      HWIO layout of the forward conv they transpose. The same permute
      gives ``conv_transpose2d``'s ``(in, out, kh, kw)``; no spatial
      flip is needed, because ``conv_transpose2d`` is already the
      adjoint of ``conv2d`` with the same weight.
    - GDN ``gamma`` is ``(C, C)`` indexed ``[k, c]`` and stays as it is;
      biases and betas are ``(C,)``.
    """
    params = {}
    for (name, value) in params_np.items():
        tensor = torch.from_numpy(numpy.array(value, dtype=numpy.float32))
        if name in CONV_NAMES:
            tensor = tensor.permute(3, 2, 0, 1).contiguous()
        params[name] = tensor
    return params


def int8_params_from_jax(qparams_np):
    """The reference's int8 weight store, as numpy, -> this package's.

    Each conv entry is ``{"int8": int8 kernel, "scale": fp32 scale with
    kept dimensions}`` in the reference's layouts; both take the same
    permute as a kernel, so a scale stays beside its output channel
    (axis 0 for an encoder kernel, axis 1 for a decoder one). Everything
    else goes through :func:`params_from_jax`.
    """
    store = {name: value for (name, value) in qparams_np.items() if isinstance(value, dict)}
    qparams = params_from_jax({name: value for (name, value) in qparams_np.items()
                               if name not in store})
    for (name, value) in store.items():
        qparams[name] = {
            "int8": torch.from_numpy(numpy.array(value["int8"], dtype=numpy.int8)
                                     ).permute(3, 2, 0, 1).contiguous(),
            "scale": torch.from_numpy(numpy.array(value["scale"], dtype=numpy.float32)
                                      ).permute(3, 2, 0, 1).contiguous()}
    return qparams


def params_to_jax(params):
    """The inverse of :func:`params_from_jax`: a dict of tensors in this
    package's layouts (on any device) -> numpy arrays in the
    reference's. Adam's moments take the same way as the kernels they
    belong to."""
    params_np = {}
    for (name, tensor) in params.items():
        tensor = tensor.detach().cpu()
        if name in CONV_NAMES:
            tensor = tensor.permute(2, 3, 1, 0)
        params_np[name] = numpy.ascontiguousarray(tensor.numpy())
    return params_np


def state_to_jax(state):
    """A :class:`TrainState` -> ``{checkpoint key: numpy array}`` in the
    reference's key scheme and layouts."""
    arrays = {}

    def put(prefix, params):
        for (name, value) in params_to_jax(params).items():
            arrays[f"{prefix}['{name}']"] = value

    put(".params", state.params)
    arrays[".density.parameters"] = state.density.parameters.cpu().numpy()
    arrays[".density.nb_itvs_per_side"] = state.density.nb_itvs_per_side.cpu().numpy()
    arrays[".bin_widths"] = state.bin_widths.cpu().numpy()
    arrays[".opt_eae[0].count"] = state.opt_eae.count.cpu().numpy()
    put(".opt_eae[0].mu", state.opt_eae.mu)
    put(".opt_eae[0].nu", state.opt_eae.nu)
    arrays[".opt_eae[1].count"] = state.opt_eae.count.cpu().numpy()
    arrays[".step"] = state.step.cpu().numpy()
    return arrays


def _split_key(key):
    """``".opt_eae[0].mu['gamma_1']"`` -> ``(".opt_eae[0].mu", "gamma_1")``;
    a key without a dict entry -> ``(key, None)``."""
    if key.endswith("']") and "['" in key:
        (prefix, name) = key[:-2].split("['", 1)
        return (prefix, name)
    return (key, None)


def state_from_jax(arrays):
    """``{checkpoint key: numpy array}`` in the reference's key scheme
    and layouts -> a :class:`TrainState` of CPU tensors. Raises on a key
    this package's state has no place for, on a missing one, and when
    the optimiser's two update counts differ."""
    groups = {".params": {}, ".opt_eae[0].mu": {}, ".opt_eae[0].nu": {}}
    leaves = {}
    for (key, value) in arrays.items():
        (prefix, name) = _split_key(key)
        if name is not None and prefix in groups:
            groups[prefix][name] = value
        else:
            leaves[key] = value
    wanted = [".density.parameters", ".density.nb_itvs_per_side", ".bin_widths",
              ".opt_eae[0].count", ".opt_eae[1].count", ".step"]
    missing = [key for key in wanted if key not in leaves]
    extra = sorted(set(leaves) - set(wanted))
    if missing or extra or not groups[".params"]:
        raise ValueError(f"Not a training state: missing {missing}, unexpected {extra}, "
                         f"{len(groups['.params'])} parameters.")
    for prefix in (".opt_eae[0].mu", ".opt_eae[0].nu"):
        if set(groups[prefix]) != set(groups[".params"]):
            raise ValueError(f"{prefix} and .params hold different names.")
    if int(leaves[".opt_eae[0].count"]) != int(leaves[".opt_eae[1].count"]):
        raise ValueError("The optimiser's two update counts differ: "
                         f"{leaves['.opt_eae[0].count']} and {leaves['.opt_eae[1].count']}.")

    def tensor(key, dtype):
        return torch.from_numpy(numpy.array(leaves[key], dtype=dtype))

    return TrainState(
        params=params_from_jax(groups[".params"]),
        density=DensityTable(tensor(".density.parameters", numpy.float32),
                             tensor(".density.nb_itvs_per_side", numpy.int32)),
        bin_widths=tensor(".bin_widths", numpy.float32),
        opt_eae=AdamState(tensor(".opt_eae[0].count", numpy.int32),
                          params_from_jax(groups[".opt_eae[0].mu"]),
                          params_from_jax(groups[".opt_eae[0].nu"])),
        step=tensor(".step", numpy.int32))


def _numpy_group(prefix, tensors):
    return {f"{prefix}['{name}']": tensor.detach().cpu().numpy()
            for (name, tensor) in tensors.items()}


def _groups(arrays, what, prefixes, leaf_keys):
    """``({prefix: {name: array}}, leaves)`` of a state's arrays, numpy:
    the dict entries under each of ``prefixes`` (the first the
    parameters) and the other keys, which must be ``leaf_keys``; raises on
    a missing or unexpected key and on a group whose names differ from
    the parameters'."""
    groups = {prefix: {} for prefix in prefixes}
    leaves = {}
    for (key, value) in arrays.items():
        (prefix, name) = _split_key(key)
        if name is not None and prefix in groups:
            groups[prefix][name] = value
        else:
            leaves[key] = value
    missing = [key for key in leaf_keys if key not in leaves]
    extra = sorted(set(leaves) - set(leaf_keys))
    if missing or extra or not groups[prefixes[0]]:
        raise ValueError(f"Not a {what}: missing {missing}, unexpected {extra}, "
                         f"{len(groups[prefixes[0]])} parameters.")
    for prefix in prefixes[1:]:
        if set(groups[prefix]) != set(groups[prefixes[0]]):
            raise ValueError(f"{prefix} and {prefixes[0]} hold different names.")
    return (groups, leaves)


def _svhn_groups(arrays, what, leaf_keys):
    """``(params, momentum, leaves)`` of an SVHN state's arrays (:func:`_groups`)."""
    (groups, leaves) = _groups(arrays, what, (".params", ".momentum"), leaf_keys)
    return (groups[".params"], groups[".momentum"], leaves)


def _tensors(arrays, dtype=numpy.float32):
    return {name: torch.from_numpy(numpy.array(value, dtype=dtype))
            for (name, value) in arrays.items()}


_DENSE_LEAVES = (".density.parameters", ".density.nb_itvs_per_side", ".bin_width", ".step")


def dense_state_to_jax(state):
    """A :class:`DenseEaeState` -> ``{checkpoint key: numpy array}`` in the
    reference's key scheme (weights ``(in, out)`` in both packages)."""
    arrays = {**_numpy_group(".params", state.params),
              **_numpy_group(".momentum", state.momentum)}
    arrays[".density.parameters"] = state.density.parameters.cpu().numpy()
    arrays[".density.nb_itvs_per_side"] = state.density.nb_itvs_per_side.cpu().numpy()
    arrays[".bin_width"] = state.bin_width.cpu().numpy()
    arrays[".step"] = state.step.cpu().numpy()
    return arrays


def dense_state_from_jax(arrays):
    """The inverse of :func:`dense_state_to_jax`: a :class:`DenseEaeState`
    of CPU tensors."""
    (params, momentum, leaves) = _svhn_groups(arrays, "dense EAE state", _DENSE_LEAVES)
    (floats, ints) = (_tensors(leaves), _tensors(leaves, numpy.int32))
    return DenseEaeState(
        params=_tensors(params), momentum=_tensors(momentum),
        density=DensityTable(floats[".density.parameters"], ints[".density.nb_itvs_per_side"]),
        bin_width=floats[".bin_width"], step=ints[".step"])


def vae_state_to_jax(state):
    """A :class:`VaeState` -> ``{checkpoint key: numpy array}``."""
    return {**_numpy_group(".params", state.params),
            **_numpy_group(".momentum", state.momentum),
            ".step": state.step.cpu().numpy()}


def vae_state_from_jax(arrays):
    """The inverse of :func:`vae_state_to_jax`: a :class:`VaeState` of CPU
    tensors."""
    (params, momentum, leaves) = _svhn_groups(arrays, "VAE state", (".step",))
    return VaeState(params=_tensors(params), momentum=_tensors(momentum),
                    step=_tensors(leaves, numpy.int32)[".step"])


def hyperprior_state_to_arrays(state):
    """A :class:`HyperpriorState` -> ``{checkpoint key: numpy array}``."""
    return {**_numpy_group(".params", state.params), ".opt.count": state.opt.count.cpu().numpy(),
            **_numpy_group(".opt.mu", state.opt.mu), **_numpy_group(".opt.nu", state.opt.nu),
            ".step": state.step.cpu().numpy()}


def hyperprior_state_from_arrays(arrays):
    """The inverse of :func:`hyperprior_state_to_arrays`: a
    :class:`HyperpriorState` of CPU tensors (raises as :func:`_groups`, and
    on vectors of another length than the model's parameters)."""
    (groups, leaves) = _groups(arrays, "hyperprior state", (".params", ".opt.mu", ".opt.nu"),
                               (".opt.count", ".step"))
    sizes = sorted(size_of(model) for (model, _, _) in HYPERPRIOR_MODELS.values())
    shapes = {numpy.shape(group.get("all")) for group in groups.values()}
    if len(shapes) != 1 or next(iter(shapes)) not in {(size,) for size in sizes}:
        raise ValueError(f"Not a hyperprior state: its vectors are not one of the models' "
                         f"lengths {sizes}.")
    ints = _tensors(leaves, numpy.int32)
    (params, mu, nu) = (_tensors(groups[prefix]) for prefix in (".params", ".opt.mu", ".opt.nu"))
    return HyperpriorState(params=params, opt=AdamState(ints[".opt.count"], mu, nu),
                           step=ints[".step"])


# State type -> (to reference arrays, from reference arrays).
_CONVERTERS = {
    TrainState: (state_to_jax, state_from_jax),
    DenseEaeState: (dense_state_to_jax, dense_state_from_jax),
    VaeState: (vae_state_to_jax, vae_state_from_jax),
    HyperpriorState: (hyperprior_state_to_arrays, hyperprior_state_from_arrays),
}


def _converters(state):
    if type(state) not in _CONVERTERS:
        raise TypeError(f"no checkpoint format for a {type(state).__name__}.")
    return _CONVERTERS[type(state)]


def save_checkpoint(path, state, allow_overwrite=False):
    """Writes a state (:class:`TrainState`, :class:`DenseEaeState`,
    :class:`VaeState` or :class:`HyperpriorState`) to ``<path>.npz`` and
    then ``<path>.json`` (meta)."""
    npz_path = path + ".npz"
    if os.path.isfile(npz_path) and not allow_overwrite:
        raise FileExistsError(
            f"{npz_path} already exists; refusing to overwrite a checkpoint.")
    arrays = _converters(state)[0](state)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    numpy.savez(npz_path, **arrays)
    nb_itvs = arrays.get(".density.nb_itvs_per_side")
    meta = {
        "nb_leaves": len(arrays),
        "step": int(arrays[".step"]),
        "nb_itvs_per_side": None if nb_itvs is None else int(nb_itvs),
        # Per-epoch saves are intermediate until the training part
        # finishes and calls mark_checkpoint_complete.
        "part_complete": False,
    }
    with open(path + ".json", "w") as file:
        json.dump(meta, file, indent=2)


def load_checkpoint(path, template):
    """Restores a state saved by :func:`save_checkpoint` (of either
    package), onto the device of ``template``.

    ``template`` is a state of the same type and structure (e.g. from
    ``init_train_state`` with the same experiment configuration): its
    keys and shapes select the stored arrays, so a renamed, missing,
    extra or reshaped leaf raises.

    A ``<path>.npz`` without its ``<path>.json`` sidecar is refused: the
    meta is written last, so a missing sidecar means the writer died
    mid-save and the npz may be truncated.
    """
    if not os.path.isfile(path + ".json"):
        raise FileNotFoundError(
            f"{path}.json is missing: {path}.npz is a half-written "
            "checkpoint (the meta sidecar is written last). Delete the "
            "leftover npz and resume from the previous part.")
    (to_jax, from_jax) = _converters(template)
    wanted = to_jax(template)
    with numpy.load(path + ".npz") as data:
        stored = set(data.files)
        missing = [key for key in wanted if key not in stored]
        extra = sorted(stored - set(wanted))
        if missing or extra:
            raise ValueError(
                "Checkpoint/template key mismatch. Missing from checkpoint: "
                f"{missing}; unexpected in checkpoint: {extra}.")
        arrays = {key: data[key] for key in wanted}
    for (key, leaf) in wanted.items():
        if tuple(arrays[key].shape) != tuple(leaf.shape):
            raise ValueError(f"Leaf {key}: checkpoint shape {arrays[key].shape} != "
                             f"template shape {leaf.shape}.")
    return state_to(from_jax(arrays), template.step.device)


def checkpoint_exists(path):
    """True when ``<path>.npz`` is on disk."""
    return os.path.isfile(path + ".npz")


def mark_checkpoint_complete(path):
    """Stamps ``<path>.json`` as the END of a finished training part.

    The training CLI saves a checkpoint after every epoch, so mere
    existence cannot tell a finished part from an interrupted one;
    resumable runs check :func:`checkpoint_part_complete`."""
    meta_path = path + ".json"
    with open(meta_path) as file:
        meta = json.load(file)
    meta["part_complete"] = True
    with open(meta_path, "w") as file:
        json.dump(meta, file, indent=2)


def checkpoint_part_complete(path):
    """True when the part that produced ``<path>`` ran to completion. A
    missing sidecar means an interrupted save: not complete."""
    meta_path = path + ".json"
    if not os.path.isfile(meta_path):
        return False
    with open(meta_path) as file:
        return bool(json.load(file).get("part_complete", True))


def save_params_artifact(path_npz, params, bin_widths, step=None):
    """Compressed params-only export (no optimiser or density state), in
    the reference's layouts. ``step`` records the training step the
    params came from, so that consumers pairing this artifact with the
    coding statistics can detect a mismatched pair."""
    arrays = {f"param:{name}": value for (name, value) in params_to_jax(params).items()}
    arrays["bin_widths"] = torch.as_tensor(bin_widths).detach().cpu().numpy()
    if step is not None:
        arrays["step"] = numpy.asarray(int(step), dtype=numpy.int64)
    os.makedirs(os.path.dirname(path_npz) or ".", exist_ok=True)
    numpy.savez_compressed(path_npz, **arrays)


def params_artifact_step(path_npz):
    """Training step recorded in a params artifact, or None (old export)."""
    with numpy.load(path_npz) as data:
        return int(data["step"]) if "step" in data.files else None
