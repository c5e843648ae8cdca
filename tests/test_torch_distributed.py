"""The port's distributed layer across two real processes (gloo, CPU).

Two Python processes (``tests/torch_distributed_worker.py``) join one
``torch.distributed`` world; each feeds only its own shard of a global
batch of 8 crops of 32 x 32 to the sharded step functions, over
``(data=2, model=1)`` and over ``(data=1, model=2)`` (the density table
and the bin widths then split across the processes), and runs the
height-sharded round trip with one band of each image a process. The
results are held against the single-process port step on the whole
batch with the same noise, and against the JAX package's sharded
functions on its 8-device CPU mesh.

Two cases are built to catch the step's non-additive parts: the largest
latent lies on the other process's half of the batch (the grid must grow
from the global maximum), and a map's entropy mean is negative on one
half and positive on the other (the clamp must see the global mean).

Tolerances: losses and gradients within 1e-5 of each tensor's largest
entry; after one ``train_step``, the density table within 2.6e-6 and
the bin widths and every Adam-updated weight within 1.1e-6, except that
a weight whose gradient is under 1e-3 of its tensor's largest entry may
move by up to two learning rates either way (Adam's first step turns
reduction-order noise on a near-zero gradient into a sign); the port's
sharded evaluation within rtol 1e-4 of the JAX package's; the spatial
round trip within rtol 1e-4, atol 1e-4.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import socket
import subprocess
import sys

import jax
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.models import conv_eae as jax_conv_eae
from autoencoder_based_image_compression_tpu.parallel.inference import (
    roundtrip_batched as jax_roundtrip_batched,
)
from autoencoder_based_image_compression_tpu.parallel.mesh import make_mesh as jax_make_mesh
from autoencoder_based_image_compression_tpu.parallel.train_parallel import (
    make_sharded_step_fns as jax_make_sharded_step_fns,
)
from autoencoder_based_image_compression_tpu.parallel.train_parallel import (
    shard_state as jax_shard_state,
)
from autoencoder_based_image_compression_tpu.train.checkpoint import _path_keys
from autoencoder_based_image_compression_tpu.train.state import (
    init_train_state as jax_init_train_state,
)
from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops import density as dens
from autoencoder_based_image_compression_tpu_torch.parallel.inference import roundtrip_batched
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
    state_from_jax,
    state_to_jax,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.train.step import (
    _flatten_maps,
    make_step_fns,
    rd_gradients,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000",
                       "params_trained.npz")
GAMMA = 10000.0
(BATCH, CROP, LATENT) = (8, 32, (8, 2, 2, 128))
TRAINING_CASES = ("data", "model", "fixed", "trap_a", "trap_b")
SPATIAL_CASES = ("spatial_learned", "spatial_fixed")
PPI = csts.NB_POINTS_PER_INTERVAL

needs_jax_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                    reason="needs the 8-device CPU platform")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's tensors, restored after: the
    tier-1 run puts six test processes on the machine's cores at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _jax_noise(seed):
    return numpy.asarray(jax.random.uniform(jax.random.PRNGKey(seed), LATENT,
                                            minval=-0.5, maxval=0.5))


def _jax_state_arrays(learn_bin_widths):
    state = jax_init_train_state(jax.random.PRNGKey(0), GAMMA, bin_width_init=1.0,
                                 learn_bin_widths=learn_bin_widths, max_itvs=16)
    return (state, {key: numpy.asarray(leaf) for (key, leaf) in _path_keys(state)})


def _trained_state(max_itvs):
    (params, bin_widths) = load_params_artifact(LEARNED)
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=max_itvs,
                             device="cpu")
    return state._replace(params=params_from_jax(params),
                          bin_widths=torch.from_numpy(bin_widths))


def _random_batch(seed=7):
    rng = numpy.random.default_rng(seed)
    return rng.integers(0, 256, size=(BATCH, CROP, CROP, 1)).astype(numpy.float32)


def _half_flat_batch(flat_half):
    """Textured crops on one half of the batch, flat grey on the other."""
    batch = synthetic_luminance_stack(BATCH, CROP, CROP, seed=7).astype(numpy.float32)
    rows = slice(0, BATCH // 2) if flat_half == 0 else slice(BATCH // 2, BATCH)
    batch[rows] = 128.0
    return batch


def _per_half_entropy(state, batch, noise, max_itvs):
    """Per-map approximate entropy of each half of the batch, unclamped."""
    y = conv_eae.encode(state.params, torch.from_numpy(batch), True)
    y_tilde = y + state.bin_widths * torch.from_numpy(noise)
    halves = []
    for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        prob = dens.approximate_probability(_flatten_maps(y_tilde[rows]),
                                            state.density.parameters, PPI, max_itvs)
        halves.append(dens.approximate_entropy_per_map(prob, state.bin_widths))
    return (y, halves)


def _trap_b_state(batch):
    """The trained model with its density table raised to 4 around the
    flat half's noisy latents, map by map: there ``-log2 p`` is -2, so
    that half's per-map entropy mean falls below 0 while the textured
    half's stays above."""
    state = _trained_state(16)
    y = conv_eae.encode(state.params, torch.from_numpy(batch[:BATCH // 2]), True)
    spread = 0.5 * state.bin_widths
    (low, high) = ((y - spread).amin(dim=(0, 1, 2)), (y + spread).amax(dim=(0, 1, 2)))
    grid = torch.from_numpy(dens.table_grid(PPI, 16))
    inside = (grid[None, :] >= low[:, None] - 1.0 / PPI) & (grid[None, :] <= high[:, None]
                                                          + 1.0 / PPI)
    live = dens.active_mask(state.density.nb_itvs_per_side, PPI, 16) > 0
    parameters = torch.where(inside & live, torch.tensor(4.0), state.density.parameters)
    return state._replace(density=state.density._replace(parameters=parameters))


def _cases():
    """{case: (state arrays, batch, noise_fct, noise_eae, flags)}."""
    (noise_fct, noise_eae) = (_jax_noise(1), _jax_noise(2))
    cases = {}
    for (case, learn_bin_widths, model) in (("data", True, 1), ("model", True, 2),
                                            ("fixed", False, 1)):
        (_, arrays) = _jax_state_arrays(learn_bin_widths)
        cases[case] = (arrays, _random_batch(), noise_fct, noise_eae,
                       dict(learn_bin_widths=learn_bin_widths, max_itvs=16, model=model))
    # (a): the flat half holds the batch's largest latents, on process 1.
    cases["trap_a"] = (state_to_jax(_trained_state(48)), _half_flat_batch(1), noise_fct,
                       noise_eae, dict(learn_bin_widths=True, max_itvs=48, model=1))
    batch = _half_flat_batch(0)
    cases["trap_b"] = (state_to_jax(_trap_b_state(batch)), batch, noise_fct,
                       noise_eae, dict(learn_bin_widths=True, max_itvs=16, model=1))
    return cases


def _spatial_inputs(learn_bin_widths):
    params = jax_conv_eae.init_conv_eae_params(jax.random.PRNGKey(2), learn_bin_widths)
    images = numpy.random.default_rng(3).integers(0, 256, size=(4, 64, 64, 1)).astype(
        numpy.uint8)
    return (params, images, numpy.ones(128, numpy.float32))


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Runs the two workers once over every case; returns ``(cases,
    per-rank results, per-rank stdout)``."""
    directory = tmp_path_factory.mktemp("gloo")
    cases = _cases()
    flat = {}
    for (case, (arrays, batch, noise_fct, noise_eae, flags)) in cases.items():
        for (key, value) in arrays.items():
            flat[f"{case}|state|{key}"] = value
        flat.update({f"{case}|batch": batch, f"{case}|noise_fct": noise_fct,
                     f"{case}|noise_eae": noise_eae, f"{case}|flag|gamma": GAMMA})
        for (name, value) in flags.items():
            flat[f"{case}|flag|{name}"] = numpy.asarray(value)
    for (case, learn_bin_widths) in zip(SPATIAL_CASES, (True, False)):
        (params, images, bin_widths) = _spatial_inputs(learn_bin_widths)
        for (name, value) in params.items():
            flat[f"{case}|param:{name}"] = numpy.asarray(value)
        flat.update({f"{case}|images": images, f"{case}|bin_widths": bin_widths,
                     f"{case}|flag|learn_bin_widths": numpy.asarray(learn_bin_widths)})
    numpy.savez(directory / "inputs.npz", **flat)

    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for (k, v) in os.environ.items() if k not in ("XLA_FLAGS",)}
    workers = [subprocess.Popen(
        [sys.executable, WORKER, coordinator, "2", str(pid), str(directory)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outputs = []
    try:
        for worker in workers:
            (out, err) = worker.communicate(timeout=120)
            outputs.append((worker.returncode, out, err))
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
    for (rc, out, err) in outputs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err}"
    results = [numpy.load(directory / f"rank{pid}.npz") for pid in range(2)]
    return (cases, results, [out for (_, out, _) in outputs])


def _single_process(case, cases):
    (arrays, batch, noise_fct, noise_eae, flags) = cases[case]
    state = state_from_jax(arrays)
    (lbw, max_itvs) = (flags["learn_bin_widths"], flags["max_itvs"])
    (batch, noise_fct, noise_eae) = (torch.from_numpy(a) for a in (batch, noise_fct, noise_eae))
    fns = make_step_fns(GAMMA, lbw, max_itvs=max_itvs)
    return (state, fns["train_step"](state, batch, (noise_fct, noise_eae)),
            rd_gradients(state, batch, noise_eae, GAMMA, lbw, PPI, max_itvs),
            fns["evaluation"](state, batch, noise_fct))


def _gap_to_max(got, expected):
    expected = numpy.asarray(expected, numpy.float64)
    return float(numpy.abs(numpy.asarray(got, numpy.float64) - expected).max()
                 / max(numpy.abs(expected).max(), 1e-30))


def test_every_process_prints_the_same_checksums(two_processes):
    (_, _, outs) = two_processes
    lines = [sorted(line.rsplit(" rank ", 1)[0] for line in out.splitlines()
                    if line.startswith("CHECKSUM")) for out in outs]
    assert len(lines[0]) == len(TRAINING_CASES) + len(SPATIAL_CASES)
    assert lines[0] == lines[1]
    assert all(float(line.split()[2]) > 0.0 for line in lines[0])


@pytest.mark.parametrize("case", TRAINING_CASES)
def test_sharded_gradients_match_the_single_process_step(two_processes, case):
    (cases, results, _) = two_processes
    (_, _, (grads, grads_bw, loss), _) = _single_process(case, cases)
    for result in results:
        assert _gap_to_max(result[f"{case}|loss"], loss.numpy()) <= 1e-5
        for (name, grad) in grads.items():
            assert _gap_to_max(result[f"{case}|grad|{name}"], grad.numpy()) <= 1e-5, name
        if grads_bw is not None:
            assert _gap_to_max(result[f"{case}|grad_bw"], grads_bw.numpy()) <= 1e-5


@pytest.mark.parametrize("case", TRAINING_CASES)
def test_sharded_train_step_matches_the_single_process_step(two_processes, case):
    (cases, results, _) = two_processes
    (_, expected, (grads, _, _), _) = _single_process(case, cases)
    expected_arrays = state_to_jax(expected)
    bound_adam = 2.0 * csts.LR_EAE * (1.0 + 1e-4)
    for result in results:
        got = {key[len(f"{case}|state|"):]: result[key] for key in result.files
               if key.startswith(f"{case}|state|")}
        assert set(got) == set(expected_arrays)
        numpy.testing.assert_array_equal(got[".density.nb_itvs_per_side"],
                                         expected_arrays[".density.nb_itvs_per_side"])
        numpy.testing.assert_array_equal(got[".step"], expected_arrays[".step"])
        numpy.testing.assert_allclose(got[".density.parameters"],
                                      expected_arrays[".density.parameters"], rtol=0, atol=2.6e-6)
        numpy.testing.assert_allclose(got[".bin_widths"], expected_arrays[".bin_widths"],
                                      rtol=0, atol=1.1e-6)
        got_params = params_from_jax({key[len(".params['"):-2]: value
                                      for (key, value) in got.items()
                                      if key.startswith(".params[")})
        for (name, value) in expected.params.items():
            gap = numpy.abs(got_params[name].numpy() - value.numpy())
            grad = numpy.abs(grads[name].numpy())
            small = grad < 1e-3 * grad.max()
            assert gap[~small].max(initial=0.0) <= 1.1e-6, name
            assert gap[small].max(initial=0.0) <= bound_adam, name


def test_the_model_split_holds_half_the_maps_on_each_process(two_processes):
    (_, results, _) = two_processes
    for result in results:
        assert int(result["model|held_rows"]) == 64
        assert int(result["data|held_rows"]) == 128


def test_trap_a_case_grows_the_grid_from_the_other_process(two_processes):
    """The case catches a grid grown from the local maximum: process 0's
    half alone grows it less than the whole batch does."""
    (cases, results, _) = two_processes
    (arrays, batch, _, _, flags) = cases["trap_a"]
    state = state_from_jax(arrays)
    y = conv_eae.encode(state.params, torch.from_numpy(batch), True)
    half = y[:BATCH // 2].abs().max()
    whole = y.abs().max()
    extra = 0.5 * state.bin_widths.max()
    grown = [int(dens.expand_table(state.density, m + extra, PPI,
                                   flags["max_itvs"]).nb_itvs_per_side) for m in (half, whole)]
    assert grown[0] < grown[1] < flags["max_itvs"]
    (_, expected, _, _) = _single_process("trap_a", cases)
    for result in results:
        assert int(result["trap_a|state|.density.nb_itvs_per_side"]) == grown[1] == int(
            expected.density.nb_itvs_per_side)


def test_trap_b_case_has_a_map_of_either_sign_on_the_two_halves(two_processes):
    """The case catches a clamp of each process's mean: some map's
    entropy mean is under 0 on one half and over 0 on the other, and
    the two orders of clamping and averaging differ."""
    (cases, _, _) = two_processes
    (arrays, batch, _, noise_eae, _) = cases["trap_b"]
    (_, (first, second)) = _per_half_entropy(state_from_jax(arrays), batch, noise_eae, 16)
    mixed = (first < 0) & (second > 0)
    assert int(mixed.sum()) >= 1
    per_process = 0.5 * (first.clamp_min(0) + second.clamp_min(0)).sum()
    global_mean = (0.5 * (first + second)).clamp_min(0).sum()
    assert abs(float(per_process - global_mean)) > 1e-3 * float(global_mean)


def test_sharded_evaluation_matches_the_single_process_port(two_processes):
    (cases, results, _) = two_processes
    for case in ("data", "model", "fixed"):
        (_, _, _, (scaled_ae, rec_error, _, y, _, _, _)) = _single_process(case, cases)
        for result in results:
            numpy.testing.assert_allclose(result[f"{case}|eval_ae"], scaled_ae.numpy(),
                                          rtol=1e-5)
            numpy.testing.assert_allclose(result[f"{case}|eval_rec"], rec_error.numpy(),
                                          rtol=1e-5)
            numpy.testing.assert_allclose(result[f"{case}|eval_y"], y.numpy(), rtol=1e-5,
                                          atol=1e-6)


@needs_jax_mesh
def test_sharded_evaluation_matches_the_jax_package(two_processes):
    """The port's evaluation over (data=1, model=2) on two processes
    against the JAX package's on its (data=4, model=2) CPU mesh, same
    state, batch and noise (the noise JAX's key draws)."""
    (_, results, _) = two_processes
    (state, _) = _jax_state_arrays(True)
    mesh = jax_make_mesh(model_parallelism=2)
    sharded = jax_shard_state(state, mesh)
    fns = jax_make_sharded_step_fns(GAMMA, True, mesh, sharded, max_itvs=16)
    batch = jax.device_put(_random_batch(), fns["batch_sharding"])
    (ae, rec, y) = fns["evaluation"](sharded, batch, jax.random.PRNGKey(1))
    for result in results:
        numpy.testing.assert_allclose(result["model|eval_ae"], float(ae), rtol=1e-4)
        numpy.testing.assert_allclose(result["model|eval_rec"], float(rec), rtol=1e-4)
        numpy.testing.assert_allclose(result["model|eval_y"], numpy.asarray(y), rtol=1e-4,
                                      atol=1e-5)


@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_two_process_spatial_roundtrip_matches_the_unsharded_port(two_processes, case):
    (_, results, _) = two_processes
    learn_bin_widths = case == "spatial_learned"
    (params, images, bin_widths) = _spatial_inputs(learn_bin_widths)
    expected = roundtrip_batched(params_from_jax({k: numpy.asarray(v) for (k, v) in
                                                  params.items()}),
                                 images, bin_widths, learn_bin_widths, batch_size=4, device="cpu")
    for result in results:
        numpy.testing.assert_allclose(result[f"{case}|reconstructions"], expected, rtol=1e-4,
                                      atol=1e-4)


@needs_jax_mesh
@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_two_process_spatial_roundtrip_matches_the_jax_package(two_processes, case):
    (_, results, _) = two_processes
    learn_bin_widths = case == "spatial_learned"
    (params, images, bin_widths) = _spatial_inputs(learn_bin_widths)
    expected = jax_roundtrip_batched(params, images, bin_widths, learn_bin_widths,
                                     batch_size=4, mesh=jax_make_mesh(model_parallelism=2),
                                     spatial=True)
    for result in results:
        numpy.testing.assert_allclose(result[f"{case}|reconstructions"], expected, rtol=1e-4,
                                      atol=1e-4)
