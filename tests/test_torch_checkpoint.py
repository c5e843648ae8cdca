"""PyTorch port: checkpoints and params artifacts are interchangeable
with the JAX package's. Same npz keys, same layouts on disk (conv kernels
and their Adam moments in HWIO), so a file written by either package
loads in the other and compares equal, bit for bit: saving and loading
only permute and copy.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.train import checkpoint as jck
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu.train.step import make_step_fns as jax_step_fns
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns

GAMMA = 10000.0
MAX_ITVS = 32
ARCHS = pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])


def _jax_state(learn_bin_widths, seed=0, trained=True):
    state = jax_init(jax.random.PRNGKey(seed), GAMMA, 1.0, learn_bin_widths, max_itvs=MAX_ITVS)
    if trained:  # one step: moments, counts and the step are no longer zero
        rng = numpy.random.default_rng(seed)
        batch = jnp.asarray(rng.integers(0, 256, size=(2, 32, 32, 1)), jnp.uint8)
        state = jax_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)["train_step"](
            state, batch, jax.random.PRNGKey(seed + 1))
    return state


def _torch_state(learn_bin_widths, seed=0, trained=True):
    state = init_train_state(torch.Generator().manual_seed(seed), 1.0, learn_bin_widths,
                             max_itvs=MAX_ITVS, device="cpu")
    if trained:
        rng = numpy.random.default_rng(seed)
        batch = torch.from_numpy(rng.integers(0, 256, size=(2, 32, 32, 1)).astype(numpy.uint8))
        state = make_step_fns(GAMMA, learn_bin_widths, max_itvs=MAX_ITVS)["train_step"](
            state, batch, torch.Generator().manual_seed(seed + 1))
    return state


def _jax_arrays(state):
    return {key: numpy.asarray(leaf) for (key, leaf) in jck._path_keys(state)}


def _npz(path):
    with numpy.load(path + ".npz") as data:
        return {key: data[key] for key in data.files}


def _assert_same_arrays(got, expected):
    assert set(got) == set(expected)
    for key in expected:
        assert got[key].dtype == expected[key].dtype, key
        numpy.testing.assert_array_equal(got[key], expected[key], err_msg=key)


@ARCHS
def test_jax_save_port_load_port_save_jax_load_is_the_identity(tmp_path, learn_bin_widths):
    state = _jax_state(learn_bin_widths)
    first = str(tmp_path / "model_1")
    second = str(tmp_path / "again" / "model_1")
    jck.save_checkpoint(first, state)
    template = _torch_state(learn_bin_widths, seed=99, trained=False)
    loaded = tck.load_checkpoint(first, template)
    assert loaded.params["weights_4"].shape == (128, 128, 5, 5)
    assert loaded.params["weights_1"].shape == (128, 1, 9, 9)
    assert int(loaded.step) == 1 and loaded.step.dtype == torch.int32
    tck.save_checkpoint(second, loaded)
    # The two files hold the same keys and the same bytes of data.
    _assert_same_arrays(_npz(second), _npz(first))
    with open(first + ".json") as a, open(second + ".json") as b:
        assert json.load(a) == json.load(b)
    back = jck.load_checkpoint(second, _jax_state(learn_bin_widths, seed=7, trained=False))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
    _assert_same_arrays(_jax_arrays(back), _jax_arrays(state))


@ARCHS
def test_port_save_jax_load_port_load(tmp_path, learn_bin_widths):
    state = _torch_state(learn_bin_widths)
    path = str(tmp_path / "model_1")
    tck.save_checkpoint(path, state)
    assert tck.checkpoint_exists(path) and jck.checkpoint_exists(path)
    in_jax = jck.load_checkpoint(path, _jax_state(learn_bin_widths, seed=3, trained=False))
    _assert_same_arrays(_jax_arrays(in_jax), tck.state_to_jax(state))
    # HWIO on disk: the port's OIHW kernel and its moments, permuted.
    w2 = state.params["weights_2"].permute(2, 3, 1, 0).numpy()
    numpy.testing.assert_array_equal(numpy.asarray(in_jax.params["weights_2"]), w2)
    numpy.testing.assert_array_equal(
        numpy.asarray(in_jax.opt_eae[0].nu["weights_5"]),
        state.opt_eae.nu["weights_5"].permute(2, 3, 1, 0).numpy())
    assert int(in_jax.opt_eae[0].count) == int(in_jax.opt_eae[1].count) == 1
    again = tck.load_checkpoint(path, _torch_state(learn_bin_widths, seed=5, trained=False))
    _assert_same_arrays(tck.state_to_jax(again), tck.state_to_jax(state))


@ARCHS
def test_params_artifacts_both_ways(tmp_path, learn_bin_widths):
    jax_state = _jax_state(learn_bin_widths, trained=False)
    from_jax = str(tmp_path / "from_jax.npz")
    from_port = str(tmp_path / "sub" / "from_port.npz")
    jck.save_params_artifact(from_jax, jax_state.params, jax_state.bin_widths, step=6990)
    (params_np, bin_widths) = tck.load_params_artifact(from_jax)
    assert tck.params_artifact_step(from_jax) == 6990
    params = tck.params_from_jax(params_np)
    _assert_same_arrays(tck.params_to_jax(params), params_np)  # the inverse
    tck.save_params_artifact(from_port, params, torch.from_numpy(bin_widths), step=6990)
    (back, back_bw) = jck.load_params_artifact(from_port)
    assert jck.params_artifact_step(from_port) == tck.params_artifact_step(from_port) == 6990
    assert set(back) == set(jax_state.params)
    for name in back:
        numpy.testing.assert_array_equal(numpy.asarray(back[name]),
                                         numpy.asarray(jax_state.params[name]))
    numpy.testing.assert_array_equal(numpy.asarray(back_bw), numpy.asarray(jax_state.bin_widths))
    # Without a step the key is absent, as in the reference.
    tck.save_params_artifact(from_port, params, bin_widths)
    assert tck.params_artifact_step(from_port) is None
    assert jck.params_artifact_step(from_port) is None


def test_key_mismatches_raise(tmp_path):
    state = _torch_state(True, trained=False)
    path = str(tmp_path / "model_1")
    tck.save_checkpoint(path, state)
    # A same-shape rename must not map onto another tensor.
    renamed = dict(state.params)
    renamed["gamma_1_renamed"] = renamed.pop("gamma_1")
    with pytest.raises(ValueError, match="gamma_1"):
        tck.load_checkpoint(path, state._replace(params=renamed))
    # The other architecture has four more parameters: missing keys.
    with pytest.raises(ValueError, match="gamma_3"):
        tck.load_checkpoint(path, _torch_state(False, trained=False))
    # ... and a learned-bin-width template finds extra keys in a fixed one.
    fixed = str(tmp_path / "fixed_1")
    tck.save_checkpoint(fixed, _torch_state(False, trained=False))
    with pytest.raises(ValueError, match="unexpected in checkpoint"):
        tck.load_checkpoint(fixed, state)
    # Another table capacity: a reshaped leaf.
    wide = init_train_state(torch.Generator().manual_seed(0), 1.0, True, max_itvs=16,
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.load_checkpoint(path, wide)
    # The JAX package refuses the same file for the same reasons.
    with pytest.raises(ValueError, match="gamma_3"):
        jck.load_checkpoint(path, _jax_state(False, trained=False))


def test_state_from_jax_refuses_what_it_cannot_place():
    arrays = tck.state_to_jax(_torch_state(True, trained=False))
    with pytest.raises(ValueError, match="unexpected"):
        tck.state_from_jax({**arrays, ".opt_bw.count": numpy.zeros((), numpy.int32)})
    with pytest.raises(ValueError, match="missing"):
        tck.state_from_jax({k: v for (k, v) in arrays.items() if k != ".step"})
    with pytest.raises(ValueError, match="different names"):
        tck.state_from_jax({k: v for (k, v) in arrays.items()
                            if k != ".opt_eae[0].nu['beta_1']"})
    with pytest.raises(ValueError, match="counts differ"):
        tck.state_from_jax({**arrays, ".opt_eae[1].count": numpy.asarray(3, numpy.int32)})


def test_overwrite_refusal_interrupted_save_and_part_markers(tmp_path):
    state = _torch_state(True, trained=False)
    path = str(tmp_path / "model_1")
    assert not tck.checkpoint_exists(path) and not tck.checkpoint_part_complete(path)
    tck.save_checkpoint(path, state)
    with pytest.raises(FileExistsError):
        tck.save_checkpoint(path, state)
    tck.save_checkpoint(path, state, allow_overwrite=True)
    # Per-epoch saves are intermediate until the part is marked complete;
    # both packages read the marker.
    assert not tck.checkpoint_part_complete(path) and not jck.checkpoint_part_complete(path)
    tck.mark_checkpoint_complete(path)
    assert tck.checkpoint_part_complete(path) and jck.checkpoint_part_complete(path)
    with open(path + ".json") as file:
        meta = json.load(file)
    assert meta == {"nb_leaves": 63, "step": 0, "nb_itvs_per_side": 10, "part_complete": True}
    # An npz without its sidecar is a half-written part.
    os.remove(path + ".json")
    assert not tck.checkpoint_part_complete(path)
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(path, state)
