"""PyTorch port: the whole-ladder training command line on the CPU.

``train_ladder --device cpu`` trains two gammas for one epoch on tiny
synthetic ``.npy`` stacks: part 0 writes a complete ``model_1`` into each
gamma's experiment directory and refuses to be retrained, part 1 resumes
at part 0's step, the printed lines have the shape of the JAX package's
command line on the same files, and the JAX package (its checkpoint
loader and its ``cli/reconstruct_kodak``) reads what the port wrote.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os
import re

import jax
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import reconstruct_kodak as jax_reconstruct_kodak
from autoencoder_based_image_compression_tpu.cli import train_ladder as jax_train_ladder
from autoencoder_based_image_compression_tpu.train import checkpoint as jck
from autoencoder_based_image_compression_tpu.train.state import init_train_state as jax_init
from autoencoder_based_image_compression_tpu_torch.cli import train_ladder
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

BATCH = 2
NB_TRAINING = 6
GAMMAS = [10000.0, 96000.0]
EXPERIMENTS = ["1_10000", "1_96000"]


@pytest.fixture()
def data(tmp_path):
    paths = {}
    for (name, count, seed) in (("training", NB_TRAINING, 0), ("validation", 2, 1)):
        paths[name] = str(tmp_path / f"{name}.npy")
        numpy.save(paths[name], synthetic_luminance_stack(count, 32, 32, seed))
    return paths


def _args(data, results_root, idx_training, *extra):
    return ["1.0", str(idx_training), "--gammas", "10000", "96000", "--nb_epochs_training", "1",
            "--batch_size", str(BATCH), "--nb_eval_examples", "2",
            "--path_to_training_data", data["training"],
            "--path_to_validation_data", data["validation"],
            "--results_root", results_root, *extra]


def _shape(printed):
    """The printed lines with every number replaced by ``#``."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in printed.splitlines() if line.strip()]


def test_train_ladder_parts_resume_and_printed_lines(tmp_path, data, capsys):
    root = str(tmp_path / "port")
    train_ladder.main(_args(data, root, 0, "--device", "cpu"))
    printed = capsys.readouterr().out
    nb_batches = NB_TRAINING // BATCH
    assert sorted(os.listdir(os.path.join(root, "fixed_bw"))) == EXPERIMENTS
    for name in EXPERIMENTS:
        model_1 = os.path.join(root, "fixed_bw", name, "model_1")
        assert tck.checkpoint_exists(model_1) and tck.checkpoint_part_complete(model_1)
        with open(model_1 + ".json") as file:
            meta = json.load(file)
        assert meta["step"] == nb_batches and meta["part_complete"] is True
    assert "Epoch 1 (global step 0):" in printed
    assert "ladder-steps/s" in printed and "model-Mpix/s aggregate" in printed
    assert "ladder part 0 (2 models) done" in printed

    # The same command line of the JAX package on the same files prints
    # lines of the same shape (numbers aside).
    jax_train_ladder.main(_args(data, str(tmp_path / "jax"), 0))
    jax_printed = capsys.readouterr().out
    assert _shape(printed) == _shape(jax_printed)
    assert len(_shape(printed)) == 5

    # A finished part is not retrained; part 1 resumes from part 0.
    with pytest.raises(RuntimeError, match="refusing to retrain"):
        train_ladder.main(_args(data, root, 0, "--device", "cpu"))
    train_ladder.main(_args(data, root, 1, "--device", "cpu"))
    printed = capsys.readouterr().out
    assert f"Epoch 1 (global step {nb_batches}):" in printed
    template = init_train_state(torch.Generator().manual_seed(0), 1.0, False, device="cpu")
    states = {}
    for name in EXPERIMENTS:
        resumed = tck.load_checkpoint(os.path.join(root, "fixed_bw", name, "model_2"), template)
        assert int(resumed.step) == int(resumed.opt_eae.count) == 2 * nb_batches
        assert torch.equal(resumed.bin_widths, torch.ones(128))
        states[name] = resumed
    # Two gammas, two models.
    assert not torch.allclose(states["1_10000"].params["weights_1"],
                              states["1_96000"].params["weights_1"])


def test_the_jax_package_reads_what_the_ladder_cli_wrote(tmp_path, data):
    root = str(tmp_path / "port")
    train_ladder.main(_args(data, root, 0, "--device", "cpu"))
    for (gamma, name) in zip(GAMMAS, EXPERIMENTS):
        model_1 = os.path.join(root, "fixed_bw", name, "model_1")
        in_jax = jck.load_checkpoint(model_1, jax_init(jax.random.PRNGKey(0), gamma, 1.0, False))
        assert int(in_jax.step) == NB_TRAINING // BATCH
        port = tck.load_checkpoint(
            model_1, init_train_state(torch.Generator().manual_seed(0), 1.0, False, device="cpu"))
        numpy.testing.assert_array_equal(numpy.asarray(in_jax.params["gamma_3"]),
                                         port.params["gamma_3"].numpy())
        # The loader of the JAX package's RD evaluation finds the model.
        state = jax_reconstruct_kodak._load_state(root, 1.0, gamma, False, 1)
        assert state is not None and int(state.step) == NB_TRAINING // BATCH
    assert jax_reconstruct_kodak._load_state(root, 1.0, 12000.0, False, 1) is None


def test_train_ladder_refuses_cuda_without_a_card(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_ladder.main(_args(data, str(tmp_path / "r"), 0))
    assert train_ladder.build_parser().parse_args(["1.0", "0"]).device == "cuda"


def test_parser_has_the_jax_arguments_plus_device():
    def options(parser):
        return {action.dest: (action.default, action.option_strings)
                for action in parser._actions if action.dest != "help"}

    ours = options(train_ladder.build_parser())
    theirs = options(jax_train_ladder.build_parser())
    assert ours.pop("device") == ("cuda", ["--device"])
    assert ours == theirs
    assert train_ladder.GAMMAS_DEFAULT == jax_train_ladder.GAMMAS_DEFAULT
    for bad in (["0", "0"], ["1.0", "-1"], ["1.0", "0", "--gammas", "-5"]):
        with pytest.raises(SystemExit):
            train_ladder.build_parser().parse_args(bad)
