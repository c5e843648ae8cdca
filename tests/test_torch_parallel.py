"""PyTorch port: the sharded training step, the sharded ladder and
data-parallel serving on one-process meshes of CPU shards (the
counterpart of the JAX package's 8-device CPU tests), held against the
port's unsharded paths and the JAX package's sharded evaluation.

Tolerances: gradients and losses within 1e-5 of each tensor's largest
entry; after a step the density table within 2.6e-6, the bin widths and
weights within 1.1e-6, except that a weight whose gradient is under 1e-3
of its tensor's largest entry may move by up to two learning rates
(Adam's first step turns reduction-order noise into a sign); the sharded
ladder within rtol 1e-6 / atol 1e-7 with
``nb_itvs_per_side`` equal (``tests/test_ladder.py``); bit counts equal.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import jax
import numpy
import pytest
import torch

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
from autoencoder_based_image_compression_tpu_torch.dryrun import dryrun_multichip
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.parallel import (
    distributed,
    fetch_replicated,
    make_mesh,
)
from autoencoder_based_image_compression_tpu_torch.parallel.continuous_batching import (
    stream_roundtrip,
)
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    PipelinedCompressor,
    make_codec_fns,
    roundtrip_batched,
)
from autoencoder_based_image_compression_tpu_torch.parallel.train_parallel import (
    make_sharded_step_fns,
    shard_state,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import state_from_jax
from autoencoder_based_image_compression_tpu_torch.train.ladder import (
    LadderShards,
    init_ladder_state,
    make_ladder_step_fns,
    shard_ladder_state,
)
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns, rd_gradients

GAMMA = 10000.0
LATENT = (8, 2, 2, 128)
PPI = csts.NB_POINTS_PER_INTERVAL


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's tensors, restored after: the
    tier-1 run puts six test processes on the machine's cores at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(nb=8, seed=0):
    rng = numpy.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=(nb, 32, 32, 1)).astype(numpy.float32))


def _noise(seed, shape=LATENT):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)) - 0.5


def _state(learn_bin_widths=True):
    return init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                            max_itvs=16, device="cpu")


def _gap_to_max(got, expected):
    return float((got - expected).abs().max() / expected.abs().max().clamp_min(1e-30))


def _hold_weights(got, expected, grads):
    """Adam-updated weights within 1.1e-6, except where the gradient is
    under 1e-3 of its tensor's largest entry: there Adam's first step
    turns reduction-order noise into a sign, up to two learning rates."""
    for (name, value) in expected.items():
        gap = (got[name] - value).abs()
        small = grads[name].abs() < 1e-3 * grads[name].abs().max()
        if bool((~small).any()):
            assert float(gap[~small].max()) <= 1.1e-6, name
        if bool(small.any()):
            assert float(gap[small].max()) <= 2.0 * csts.LR_EAE * (1 + 1e-4), name


@pytest.mark.parametrize("learn_bin_widths", [True, False])
@pytest.mark.parametrize("shape", [(4, 2), (1, 2)])
def test_sharded_step_matches_the_unsharded_step(shape, learn_bin_widths):
    (n_data, n_model) = shape
    state = _state(learn_bin_widths)
    (batch, noise) = (_batch(), (_noise(1), _noise(2)))
    single = make_step_fns(GAMMA, learn_bin_widths, max_itvs=16)
    mesh = make_mesh(n_model, devices=["cpu"] * (n_data * n_model))
    sharded = shard_state(state, mesh)
    fns = make_sharded_step_fns(GAMMA, learn_bin_widths, mesh, sharded, max_itvs=16)
    (grads, grads_bw, loss) = fns["rd_gradients"](sharded, batch, noise[1])
    (plain, plain_bw, plain_loss) = rd_gradients(state, batch, noise[1], GAMMA,
                                                 learn_bin_widths, PPI, 16)
    assert abs(float(loss) - float(plain_loss)) <= 1e-5 * abs(float(plain_loss))
    for name in plain:
        assert _gap_to_max(grads[name], plain[name]) <= 1e-5, name
    if learn_bin_widths:
        assert _gap_to_max(grads_bw, plain_bw) <= 1e-5
    got = fetch_replicated(fns["train_step"](sharded, batch, noise), mesh)
    expected = single["train_step"](state, batch, noise)
    assert int(got.step) == 1 and torch.equal(got.density.nb_itvs_per_side,
                                              expected.density.nb_itvs_per_side)
    torch.testing.assert_close(got.density.parameters, expected.density.parameters, rtol=0,
                               atol=2.6e-6)
    torch.testing.assert_close(got.bin_widths, expected.bin_widths, rtol=0, atol=1.1e-6)
    (eae_grads, _, _) = rd_gradients(single["training_fct"](state, batch, noise[0]), batch,
                                     noise[1], GAMMA, learn_bin_widths, PPI, 16)
    _hold_weights(got.params, expected.params, eae_grads)


def test_sharded_step_draws_the_global_noise_from_a_generator():
    """With a generator the sharded step draws the whole batch's noise and
    takes its blocks' slices: the result does not depend on the split."""
    state = _state()
    batch = _batch()
    single = make_step_fns(GAMMA, True, max_itvs=16)
    expected = single["train_step"](state, batch, torch.Generator().manual_seed(5))
    generator = torch.Generator().manual_seed(5)
    noise = [torch.rand(LATENT, generator=generator) - 0.5 for _ in range(2)]
    (eae_grads, _, _) = rd_gradients(single["training_fct"](state, batch, noise[0]), batch,
                                     noise[1], GAMMA, True, PPI, 16)
    for n_data in (2, 4):
        mesh = make_mesh(1, devices=["cpu"] * n_data)
        fns = make_sharded_step_fns(GAMMA, True, mesh, max_itvs=16)
        got = fns["train_step"](shard_state(state, mesh), batch,
                                torch.Generator().manual_seed(5))
        torch.testing.assert_close(got.density.parameters, expected.density.parameters,
                                   rtol=0, atol=2.6e-6)
        _hold_weights(got.params, expected.params, eae_grads)


def test_sharded_step_refuses_a_batch_that_does_not_split():
    mesh = make_mesh(1, devices=["cpu"] * 3)
    fns = make_sharded_step_fns(GAMMA, True, mesh, max_itvs=16)
    with pytest.raises(ValueError, match="split evenly"):
        fns["train_step"](shard_state(_state(), mesh), _batch(8), torch.Generator())
    with pytest.raises(ValueError, match="noise of shape"):
        fns["evaluation"](shard_state(_state(), mesh), _batch(6), _noise(1))


def test_sharded_evaluation_matches_the_unsharded_port():
    state = _state()
    (batch, noise) = (_batch(), _noise(3))
    mesh = make_mesh(2, devices=["cpu"] * 8)
    fns = make_sharded_step_fns(GAMMA, True, mesh, max_itvs=16)
    (scaled_ae, rec_error, y) = fns["evaluation"](shard_state(state, mesh), batch, noise)
    expected = make_step_fns(GAMMA, True, max_itvs=16)["evaluation"](state, batch, noise)
    torch.testing.assert_close(scaled_ae, expected[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(rec_error, expected[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(y, expected[3], rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU platform")
@pytest.mark.parametrize("learn_bin_widths", [True, False])
def test_sharded_evaluation_matches_the_jax_package(learn_bin_widths):
    """Same state (carried across), batch and noise (the noise JAX's key
    draws) through both packages' sharded evaluations on (data=4, model=2)
    meshes; rtol 1e-4 (atol 1e-5 on y), as the JAX package's own test."""
    jax_state = jax_init_train_state(jax.random.PRNGKey(0), GAMMA, bin_width_init=1.0,
                                     learn_bin_widths=learn_bin_widths, max_itvs=16)
    batch = _batch()
    jax_mesh = jax_make_mesh(model_parallelism=2)
    jax_sharded = jax_shard_state(jax_state, jax_mesh)
    jax_fns = jax_make_sharded_step_fns(GAMMA, learn_bin_widths, jax_mesh, jax_sharded,
                                        max_itvs=16)
    key = jax.random.PRNGKey(1)
    expected = jax_fns["evaluation"](jax_sharded, jax.device_put(batch.numpy(),
                                                                 jax_fns["batch_sharding"]), key)
    noise = torch.from_numpy(numpy.asarray(jax.random.uniform(key, LATENT, minval=-0.5,
                                                              maxval=0.5)))
    state = state_from_jax({k: numpy.asarray(v) for (k, v) in _path_keys(jax_state)})
    mesh = make_mesh(2, devices=["cpu"] * 8)
    got = make_sharded_step_fns(GAMMA, learn_bin_widths, mesh, max_itvs=16)["evaluation"](
        shard_state(state, mesh), batch, noise)
    numpy.testing.assert_allclose(float(got[0]), float(expected[0]), rtol=1e-4)
    numpy.testing.assert_allclose(float(got[1]), float(expected[1]), rtol=1e-4)
    numpy.testing.assert_allclose(got[2].numpy(), numpy.asarray(expected[2]), rtol=1e-4,
                                  atol=1e-5)


def test_shard_ladder_state_matches_the_unsharded_ladder_step():
    gammas = [10000.0, 16000.0, 40000.0, 96000.0]
    ladder = init_ladder_state(torch.Generator().manual_seed(6), gammas, max_itvs=16,
                               device="cpu")
    fns = make_ladder_step_fns(gammas, max_itvs=16)
    batch = _batch(2, seed=12)
    noise = [(_noise(20 + k, (2, 2, 2, 128)), _noise(30 + k, (2, 2, 2, 128)))
             for k in range(len(gammas))]
    plain = fns["train_step"](ladder, batch, noise)
    mesh = make_mesh(1, devices=["cpu"] * 4)
    sharded_in = shard_ladder_state(ladder, mesh)
    assert isinstance(sharded_in, LadderShards) and sorted(sharded_in.blocks) == [0, 1, 2, 3]
    assert all(int(block.step.shape[0]) == 1 for block in sharded_in.blocks.values())
    sharded_out = fns["train_step"](sharded_in, batch, noise)
    assert isinstance(sharded_out, LadderShards)
    whole = fetch_replicated(sharded_out)
    for name in plain.params:
        numpy.testing.assert_allclose(whole.params[name].numpy(), plain.params[name].numpy(),
                                      rtol=1e-6, atol=1e-7, err_msg=name)
    numpy.testing.assert_array_equal(whole.density.nb_itvs_per_side.numpy(),
                                     plain.density.nb_itvs_per_side.numpy())
    # Two models a shard run the same stacked step over their own models.
    halves = shard_ladder_state(ladder, make_mesh(1, devices=["cpu"] * 2))
    again = fetch_replicated(fns["train_step"](halves, batch, noise))
    numpy.testing.assert_allclose(again.density.parameters.numpy(),
                                  plain.density.parameters.numpy(), rtol=1e-6, atol=1e-7)


def test_shard_ladder_state_refuses_models_that_do_not_divide():
    ladder = init_ladder_state(torch.Generator().manual_seed(6), [1e4, 2e4, 4e4],
                               max_itvs=16, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        shard_ladder_state(ladder, make_mesh(1, devices=["cpu"] * 2))


@pytest.mark.parametrize("fast_path", [None, "bf16w+"])
def test_pipelined_compressor_over_a_mesh_keeps_the_bit_counts(fast_path):
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(4), True)
    images = numpy.random.default_rng(5).integers(16, 236, size=(12, 32, 48, 1)).astype(
        numpy.uint8)
    arguments = dict(binary_probabilities=numpy.full((128, 10), 0.5),
                     map_mean=numpy.zeros(128, numpy.float32), batch_size=4,
                     fast_path=fast_path)
    (recs, bits) = PipelinedCompressor(params, numpy.ones(128, numpy.float32), True,
                                       device="cpu", **arguments)(images)
    for devices in (2, 4):
        mesh = make_mesh(1, devices=["cpu"] * devices)
        (recs_mesh, bits_mesh) = PipelinedCompressor(params, numpy.ones(128, numpy.float32),
                                                     True, mesh=mesh, **arguments)(images)
        numpy.testing.assert_array_equal(bits_mesh, bits)
        assert recs_mesh.shape == recs.shape and recs_mesh.dtype == numpy.uint8
        assert int(numpy.abs(recs_mesh.astype(int) - recs).max()) <= 1
    with pytest.raises(ValueError, match="split evenly"):
        PipelinedCompressor(params, numpy.ones(128, numpy.float32), True,
                            mesh=make_mesh(1, devices=["cpu"] * 3), **arguments)(images)


def test_stream_roundtrip_and_codec_fns_over_a_mesh():
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(4), True)
    images = numpy.random.default_rng(6).integers(0, 256, size=(6, 32, 32, 1)).astype(
        numpy.uint8)
    bin_widths = numpy.ones(128, numpy.float32)
    mesh = make_mesh(1, devices=["cpu"] * 2)
    plain = stream_roundtrip(params, bin_widths, images, batch_size=4, device="cpu")
    got = stream_roundtrip(params, bin_widths, images, batch_size=4, mesh=mesh)
    numpy.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-4)
    (encode_fn, decode_fn, put) = make_codec_fns(True, mesh)
    batch = put(images[:4].astype(numpy.float32))
    whole = decode_fn(params, encode_fn(params, batch), bin_widths).gather()
    expected = roundtrip_batched(params, images[:4], bin_widths, True, 4, device="cpu")
    numpy.testing.assert_allclose(whole.numpy(), expected, rtol=1e-5, atol=1e-4)


def test_roundtrip_batched_over_a_data_mesh_matches_unsharded():
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(4), True)
    images = numpy.random.default_rng(5).integers(0, 256, size=(8, 32, 32, 1)).astype(
        numpy.uint8)
    bin_widths = numpy.ones(128, numpy.float32)
    plain = roundtrip_batched(params, images, bin_widths, True, 8, device="cpu")
    sharded = roundtrip_batched(params, images, bin_widths, True, 8,
                                mesh=make_mesh(1, devices=["cpu"] * 8))
    numpy.testing.assert_allclose(plain, sharded, rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip_on_the_cpu(n_devices):
    summary = dryrun_multichip(n_devices, device="cpu")
    assert summary["spatial_gap"] < 5e-2


def test_distributed_module_defaults_to_one_process():
    assert not distributed.is_initialized()
    assert distributed.agree_across_processes(numpy.arange(3))
