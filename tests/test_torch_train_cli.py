"""PyTorch port: the training and statistics command lines on the CPU.

``train_eae --device cpu`` runs one epoch on tiny synthetic ``.npy``
files, part 1 resumes from part 0's checkpoint, a finished part is not
retrained, and the printed indicator block carries the same labels as
the JAX package's command line on the same files. ``collect_stats``
writes the files the serving path reads; on the same latents the
statistics layer writes files equal to the JAX package's, byte for
byte in the arrays (numpy on both sides, same float32 arithmetic).
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os
import pickle

import jax
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import collect_stats as jax_collect_stats
from autoencoder_based_image_compression_tpu.cli import train_eae as jax_train_eae
from autoencoder_based_image_compression_tpu.coding import stats as jax_stats
from autoencoder_based_image_compression_tpu.train import checkpoint as jck
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch.cli import collect_stats, train_eae
from autoencoder_based_image_compression_tpu_torch.coding import stats
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

BATCH = 2
NB_TRAINING = 6


@pytest.fixture()
def data(tmp_path):
    paths = {}
    for (name, count, seed) in (("training", NB_TRAINING, 0), ("validation", 2, 1),
                                ("extra", 4, 2)):
        paths[name] = str(tmp_path / f"{name}.npy")
        numpy.save(paths[name], synthetic_luminance_stack(count, 32, 32, seed))
    return paths


def _train_args(data, results_root, idx_training, *extra):
    return ["1.0", "10000.0", str(idx_training), "--nb_epochs_training", "1",
            "--batch_size", str(BATCH), "--nb_eval_examples", "2",
            "--path_to_training_data", data["training"],
            "--path_to_validation_data", data["validation"],
            "--results_root", results_root, *extra]


def _labels(printed):
    """The text before the first ':' of each printed line, numbers out."""
    labels = []
    for line in printed.splitlines():
        if ":" in line:
            labels.append(line.split(":")[0])
    return labels


@pytest.mark.parametrize("learn_bin_widths", [True, False], ids=["learned", "fixed"])
def test_train_eae_one_epoch_resume_and_labels(tmp_path, data, capsys, learn_bin_widths):
    flag = ["--learn_bin_widths"] if learn_bin_widths else []
    root = str(tmp_path / "port")
    exp_dir = os.path.join(root, "learning_bw" if learn_bin_widths else "fixed_bw", "1_10000")
    train_eae.main(_train_args(data, root, 0, "--device", "cpu", *flag))
    printed = capsys.readouterr().out
    model_1 = os.path.join(exp_dir, "model_1")
    assert tck.checkpoint_exists(model_1) and tck.checkpoint_part_complete(model_1)
    with open(model_1 + ".json") as file:
        meta = json.load(file)
    assert meta["step"] == NB_TRAINING // BATCH and meta["part_complete"] is True
    assert "Epoch: 1" in printed and "Global step: 0" in printed
    assert "steps/s" in printed and "training part 0 done" in printed
    # A one-epoch part draws no curves (and so needs no matplotlib).
    assert not [name for name in os.listdir(exp_dir) if name.endswith(".png")]

    # The same command line of the JAX package, on the same files:
    # the same indicator block, label for label.
    jax_root = str(tmp_path / "jax")
    jax_train_eae.main(_train_args(data, jax_root, 0, *flag))
    jax_printed = capsys.readouterr().out
    assert _labels(printed) == _labels(jax_printed)
    assert len(_labels(printed)) == 21

    # A finished part is not retrained; part 1 resumes from part 0.
    with pytest.raises(RuntimeError, match="refusing to retrain"):
        train_eae.main(_train_args(data, root, 0, "--device", "cpu", *flag))
    train_eae.main(_train_args(data, root, 1, "--device", "cpu", *flag))
    printed = capsys.readouterr().out
    assert f"Global step: {NB_TRAINING // BATCH}" in printed
    template = init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                                device="cpu")
    resumed = tck.load_checkpoint(os.path.join(exp_dir, "model_2"), template)
    assert int(resumed.step) == 2 * (NB_TRAINING // BATCH)
    assert int(resumed.opt_eae.count) == int(resumed.step)
    # The JAX package resumes from the port's checkpoint just as well.
    in_jax = jck.load_checkpoint(model_1, jax_init(jax.random.PRNGKey(0), 10000.0, 1.0,
                                                   learn_bin_widths))
    assert int(in_jax.step) == NB_TRAINING // BATCH


def test_train_eae_refuses_cuda_without_a_card(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        train_eae.main(_train_args(data, str(tmp_path / "r"), 0))
    assert train_eae.build_parser().parse_args(["1.0", "2.0", "0"]).device == "cuda"


def test_parser_has_the_jax_arguments_plus_device():
    def options(parser):
        return {action.dest: (action.default, action.option_strings)
                for action in parser._actions if action.dest != "help"}

    ours = options(train_eae.build_parser())
    theirs = options(jax_train_eae.build_parser())
    assert ours.pop("device") == ("cuda", ["--device"])
    assert ours == theirs
    for bad in (["0", "1.0", "0"], ["1.0", "-2", "0"], ["1.0", "1.0", "-1"]):
        with pytest.raises(SystemExit):
            train_eae.build_parser().parse_args(bad)


def _read_statistics(stats_dir):
    files = {}
    for name in sorted(os.listdir(stats_dir)):
        path = os.path.join(stats_dir, name)
        if name.endswith(".npy"):
            files[name] = numpy.load(path)
        elif name.endswith(".pkl"):
            with open(path, "rb") as file:
                files[name] = pickle.load(file)
    return files


def test_statistics_files_equal_the_jax_package_on_the_same_latents(tmp_path):
    rng = numpy.random.default_rng(0)
    scales = rng.uniform(0.2, 6.0, 128)
    y = (rng.standard_normal((4, 4, 6, 128)) * scales + rng.normal(0, 1, 128)).astype(
        numpy.float32)
    bin_widths = rng.uniform(0.8, 1.5, 128).astype(numpy.float32)
    dirs = {}
    for (name, module) in (("port", stats), ("jax", jax_stats)):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        paths = collect_stats.statistics_paths(str(dirs[name]))
        module.save_statistics(y, bin_widths, collect_stats.MULTIPLIERS, 10, paths[0],
                               paths[1], paths[2:])
    (ours, theirs) = (_read_statistics(dirs["port"]), _read_statistics(dirs["jax"]))
    assert list(ours) == list(theirs) and len(ours) == 2 + collect_stats.MULTIPLIERS.size
    for name in theirs:
        numpy.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    # The pieces, one by one.
    numpy.testing.assert_array_equal(
        stats.compute_binary_probabilities(y, 2.0 * bin_widths, ours["map_mean.npy"], 10),
        jax_stats.compute_binary_probabilities(y, 2.0 * bin_widths, theirs["map_mean.npy"], 10))
    assert stats.find_index_map_exception(y) == jax_stats.find_index_map_exception(y)
    numpy.testing.assert_array_equal(collect_stats.MULTIPLIERS, jax_collect_stats.MULTIPLIERS)
    # A second call leaves the files alone.
    stats.save_statistics(y + 1.0, bin_widths, collect_stats.MULTIPLIERS, 10,
                          *[collect_stats.statistics_paths(str(dirs["port"]))[i]
                            for i in (0, 1)],
                          collect_stats.statistics_paths(str(dirs["port"]))[2:])
    numpy.testing.assert_array_equal(_read_statistics(dirs["port"])["map_mean.npy"],
                                     ours["map_mean.npy"])


def test_collect_stats_from_a_checkpoint_and_from_params(tmp_path, data):
    root = str(tmp_path / "results")
    train_eae.main(_train_args(data, root, 0, "--device", "cpu", "--learn_bin_widths"))
    exp_dir = os.path.join(root, "learning_bw", "1_10000")
    common = ["1.0", "10000.0", "1", "--learn_bin_widths", "--batch_size", "2",
              "--path_to_extra_data", data["extra"], "--results_root", root,
              "--device", "cpu"]
    collect_stats.main(common)
    stats_dir = os.path.join(exp_dir, "statistics")
    from_checkpoint = _read_statistics(stats_dir)
    assert from_checkpoint["binary_probabilities_1.npy"].shape == (128, 10)
    assert from_checkpoint["map_mean.npy"].shape == (128,)
    assert 0 <= from_checkpoint["idx_map_exception.pkl"] < 128
    assert not os.path.exists(os.path.join(stats_dir, "stats_model_idx.json"))

    # The same model as a params artifact gives the same statistics, and
    # stamps the pairing marker with the artifact's step.
    template = init_train_state(torch.Generator().manual_seed(0), 1.0, True, device="cpu")
    state = tck.load_checkpoint(os.path.join(exp_dir, "model_1"), template)
    tck.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"), state.params,
                             state.bin_widths, step=int(state.step))
    for name in os.listdir(stats_dir):
        os.remove(os.path.join(stats_dir, name))
    collect_stats.main(common + ["--from_params"])
    from_params = _read_statistics(stats_dir)
    for name in from_checkpoint:
        numpy.testing.assert_array_equal(from_params[name], from_checkpoint[name], err_msg=name)
    with open(os.path.join(stats_dir, "stats_model_idx.json")) as file:
        assert json.load(file) == {"step": NB_TRAINING // BATCH}
    # Over existing statistics a newer artifact does not re-stamp the marker.
    tck.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"), state.params,
                             state.bin_widths, step=888)
    collect_stats.main(common + ["--from_params"])
    with open(os.path.join(stats_dir, "stats_model_idx.json")) as file:
        assert json.load(file) == {"step": NB_TRAINING // BATCH}

    # The JAX package's command line on the port's artifact: the latents
    # differ in the last float32 digits, so the means agree closely and
    # the probabilities up to a few symbols at bin borders.
    jax_root = str(tmp_path / "jax_results")
    jax_exp = os.path.join(jax_root, "learning_bw", "1_10000")
    os.makedirs(jax_exp)
    tck.save_params_artifact(os.path.join(jax_exp, "params_trained.npz"), state.params,
                             state.bin_widths, step=3)
    jax_collect_stats.main(common[:-2] + ["--from_params"]
                           + ["--results_root", jax_root])
    theirs = _read_statistics(os.path.join(jax_exp, "statistics"))
    assert list(theirs) == list(from_params)
    numpy.testing.assert_allclose(from_params["map_mean.npy"], theirs["map_mean.npy"],
                                  rtol=1e-4, atol=1e-5)
    numpy.testing.assert_allclose(from_params["binary_probabilities_1.npy"],
                                  theirs["binary_probabilities_1.npy"], atol=0.02)


def test_plot_training_curves_writes_a_figure(tmp_path):
    from autoencoder_based_image_compression_tpu_torch.eval.visualization import (
        plot_training_curves,
    )

    path = tmp_path / "curves.png"
    plot_training_curves({"train rec error": [3.0, 2.0, 1.5], "val rec error": [3.1, 2.4, 2.0]},
                         str(path))
    assert path.is_file() and path.stat().st_size > 0
