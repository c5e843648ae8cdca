"""PyTorch port: the SVHN side's command lines against the JAX package's,
on the CPU, on ``synthetic_svhn`` digits at full width (3072-300-200,
batch 250).

Two of them are deterministic and make exact oracles:

- ``compare_entropy_approximations``: samples and noise come from
  numpy's ``default_rng``, and the density fit is plain SGD. The
  printed tables must agree within 1e-3 bits per entry (measured: equal
  at the printed 4 decimals);
- ``reconstruct_svhn``: it encodes without noise. On one checkpoint the
  two tables must agree within the printed precision (1e-4 bpp, 1e-3 dB;
  measured: equal).

``train_svhn`` is held against the JAX command line from one initial
state with the noise JAX draws, handed to the port's command line one
``eps`` per batch: the reference draws one key a batch for both phases,
so drawing per phase would shift every later batch and the test would
fail. Checkpoints cross in both directions.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import re

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import (
    compare_entropy_approximations as jax_entropy_cli,
)
from autoencoder_based_image_compression_tpu.cli import reconstruct_svhn as jax_reconstruct
from autoencoder_based_image_compression_tpu.cli import train_svhn as jax_train
from autoencoder_based_image_compression_tpu.cli import train_vae as jax_train_vae
from autoencoder_based_image_compression_tpu.models import dense_eae as jdense
from autoencoder_based_image_compression_tpu.models import vae as jvae
from autoencoder_based_image_compression_tpu.train import checkpoint as jcheckpoint
from autoencoder_based_image_compression_tpu_torch.cli import (
    compare_entropy_approximations,
    latent_analysis,
    overfit_svhn,
    reconstruct_svhn,
    train_svhn,
    train_vae,
    visualize_model,
)
from autoencoder_based_image_compression_tpu_torch.models import dense_eae
from autoencoder_based_image_compression_tpu_torch.train import checkpoint

SUFFIX = ("learning_bw", "1_5")
TRAIN_ARGS = ["1.0", "5.0", "--learn_bin_width", "--synthetic", "--nb_epochs_training", "1"]
NUMBER = re.compile(r"-?\d+\.\d+")


def _numbers(text, start):
    """Rows of the floats printed from the line starting with ``start``."""
    lines = text.splitlines()
    first = next(i for (i, line) in enumerate(lines) if line.startswith(start))
    return [[float(v) for v in NUMBER.findall(line)] for line in lines[first + 1:]
            if line.strip() and not line.startswith(("JPEG", "using", "RD"))]


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A checkpoint of JAX ``train_svhn`` (one epoch) and what it printed."""
    root = str(tmp_path_factory.mktemp("svhn_jax"))
    from contextlib import redirect_stdout
    from io import StringIO

    printed = StringIO()
    with redirect_stdout(printed):
        jax_train.main(TRAIN_ARGS + ["--results_root", root])
    return (root, printed.getvalue())


def test_compare_entropy_approximations_matches_jax(capsys):
    table = compare_entropy_approximations.main(["--nb_samples", "4000", "--device", "cpu"])
    printed = capsys.readouterr().out
    jax_entropy_cli.main(["--nb_samples", "4000"])
    expected = capsys.readouterr().out
    assert len(table) == 8
    for name in ("gaussian", "laplace"):
        got = _numbers(printed.split(f"\n{name}")[1], "  delta")[:4]
        want = _numbers(expected.split(f"\n{name}")[1], "  delta")[:4]
        assert len(got) == 4 and all(len(row) == 4 for row in got)
        numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want), atol=1e-3)
        # Unrounded, from the port's returned table: the fitted pdf's
        # approximation within 0.05 bits of the empirical entropy here.
        for delta in (0.25, 0.5, 1.0, 2.0):
            (empirical, _, fitted) = table[(name, delta)]
            assert abs(fitted - empirical) < 0.05


def test_reconstruct_svhn_matches_jax_on_a_jax_checkpoint(jax_model, capsys):
    (root, _) = jax_model
    args = ["1.0", "5.0", "--learn_bin_width", "--results_root", root, "--nb_digits", "100",
            "--path_to_test_data", "missing.npy"]
    (rates, psnrs) = reconstruct_svhn.main(args + ["--device", "cpu"])
    printed = capsys.readouterr().out
    jax_reconstruct.main(args)
    expected = capsys.readouterr().out
    got = numpy.asarray(_numbers(printed, "multiplier"))
    want = numpy.asarray(_numbers(expected, "multiplier"))
    assert got.shape == want.shape == (8, 3)
    numpy.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-4)
    numpy.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-3)
    # The rate falls as the multiplier grows.
    assert numpy.all(numpy.diff(rates) <= 1e-12) and rates[0] > rates[-1]
    assert numpy.all(numpy.isfinite(psnrs))
    # The host anchors ran in both (Pillow is installed here).
    assert printed.count("anchor: rates") == expected.count("anchor: rates") == 2


def _jax_eps_sequence(seed, nb_batches, shape):
    """The ``eps`` JAX ``train_svhn`` draws, in order: one per pre-fit
    batch, one per training batch, then the evaluation's."""
    key = jax.random.PRNGKey(seed + 1)
    subs = []
    for _ in range(2 * nb_batches + 1):
        (key, sub) = jax.random.split(key)
        subs.append(sub)
    return [numpy.asarray(jax.random.uniform(k, shape, jnp.float32, minval=-0.5, maxval=0.5))
            for k in subs]


def test_train_svhn_matches_jax_with_one_eps_a_batch(jax_model, tmp_path, monkeypatch, capsys):
    (jax_root, jax_printed) = jax_model
    initial = jdense.init_dense_eae_state(jax.random.PRNGKey(0), 1.0)
    arrays = {k: numpy.asarray(v) for (k, v) in jcheckpoint._path_keys(initial)}
    eps = iter(_jax_eps_sequence(0, 2000 // 250, (250, 200)))
    monkeypatch.setattr(dense_eae, "init_dense_eae_state",
                        lambda *args, **kwargs: checkpoint.dense_state_from_jax(arrays))
    draw = dense_eae.uniform_eps

    def jax_eps(noise, shape, device):
        # A draw from the generator becomes JAX's next draw; a draw the
        # step functions are handed passes through.
        if isinstance(noise, torch.Generator):
            return torch.from_numpy(next(eps).copy())
        return draw(noise, shape, device)

    monkeypatch.setattr(dense_eae, "uniform_eps", jax_eps)
    train_svhn.main(TRAIN_ARGS + ["--results_root", str(tmp_path), "--device", "cpu"])
    assert next(eps, None) is None  # every draw used, none missing
    got = numpy.load(str(tmp_path.joinpath(*SUFFIX, "model.npz")))
    expected = numpy.load(f"{jax_root}/{'/'.join(SUFFIX)}/model.npz")
    assert set(got.files) == set(expected.files)
    for key in expected.files:
        if key.startswith(".params"):
            numpy.testing.assert_allclose(got[key], expected[key], atol=1e-5, err_msg=key)
        elif key.startswith(".momentum"):
            scale = numpy.abs(expected[key]).max()
            assert numpy.abs(got[key] - expected[key]).max() <= 1e-3 * scale, key
        elif key == ".density.parameters":
            numpy.testing.assert_allclose(got[key], expected[key], atol=1e-4)
        else:
            numpy.testing.assert_allclose(got[key], expected[key], rtol=1e-6, err_msg=key)
    epoch_line = [line for line in capsys.readouterr().out.splitlines()
                  if line.startswith("epoch 0")]
    want = [line for line in jax_printed.splitlines() if line.startswith("epoch 0")]
    numpy.testing.assert_allclose([float(v) for v in NUMBER.findall(epoch_line[0])],
                                  [float(v) for v in NUMBER.findall(want[0])], atol=2e-2)


def test_port_train_svhn_checkpoint_loads_in_jax_reconstruct(tmp_path, capsys):
    root = str(tmp_path)
    train_svhn.main(TRAIN_ARGS + ["--results_root", root, "--device", "cpu"])
    assert "model saved under" in capsys.readouterr().out
    args = ["1.0", "5.0", "--learn_bin_width", "--results_root", root, "--nb_digits", "50",
            "--path_to_test_data", "missing.npy"]
    jax_reconstruct.main(args)
    expected = numpy.asarray(_numbers(capsys.readouterr().out, "multiplier"))
    reconstruct_svhn.main(args + ["--device", "cpu", "--plot"])
    printed = capsys.readouterr().out
    numpy.testing.assert_allclose(numpy.asarray(_numbers(printed, "multiplier")), expected,
                                  atol=1e-3)
    assert (tmp_path.joinpath(*SUFFIX, "rate_distortion.png")).stat().st_size > 0
    with numpy.load(str(tmp_path.joinpath(*SUFFIX, "rate_distortion.npz"))) as data:
        assert "EAE learned bin width_rates" in data.files


def test_overfit_svhn_objective_falls(capsys):
    objectives = overfit_svhn.main(["--nb_epochs", "101", "--learn_bin_width", "--device",
                                    "cpu"])
    assert len(objectives) == 3 and objectives[-1] < objectives[0]
    assert "the objective above should be decreasing" in capsys.readouterr().out


def test_train_vae_train_reconstruct_generate_and_jax_loads_it(tmp_path, capsys):
    root = str(tmp_path / "vae")
    common = ["--results_root", root, "--path_to_training_data", "missing.npy"]
    losses = train_vae.main(["train", "--nb_epochs_training", "3", "--device", "cpu"] + common)
    assert len(losses) == 2 and losses[-1] < losses[0]
    rec = train_vae.main(["reconstruct", "--device", "cpu"] + common)
    samples = train_vae.main(["generate", "--device", "cpu"] + common)
    assert rec.shape == (8, 3072) and samples.shape == (16, 3072)
    assert rec.dtype == samples.dtype == numpy.uint8
    # The reference package loads the port's VAE checkpoint and runs on it.
    jax_train_vae.main(["reconstruct"] + common)
    assert numpy.load(f"{root}/reconstructions.npy").shape == (8, 3072)
    state = jcheckpoint.load_checkpoint(f"{root}/model", jvae.init_vae_state(
        jax.random.PRNGKey(0)))
    assert int(state.step) == 3 * (2000 // 250)


def test_jax_train_vae_cannot_save_its_checkpoint(tmp_path):
    # The fault of the reference that the port does not repeat: its VAE
    # state has no density, and its saver reads one after writing the npz.
    root = str(tmp_path)
    with pytest.raises(AttributeError, match="density"):
        jax_train_vae.main(["train", "--nb_epochs_training", "1", "--results_root", root,
                            "--path_to_training_data", "missing.npy"])
    assert (tmp_path / "model.npz").exists() and not (tmp_path / "model.json").exists()


@pytest.mark.parametrize("main, args", [
    (train_svhn.main, ["1.0", "5.0"]),
    (overfit_svhn.main, []),
    (reconstruct_svhn.main, ["1.0", "5.0"]),
    (compare_entropy_approximations.main, []),
    (train_vae.main, ["train"]),
    (latent_analysis.main, ["fit", "1.0", "10000.0", "0"]),
    (visualize_model.main, ["1.0", "10000.0", "0"]),
], ids=["train_svhn", "overfit_svhn", "reconstruct_svhn", "compare_entropy_approximations",
        "train_vae", "latent_analysis", "visualize_model"])
def test_command_line_refuses_cuda_without_a_card(main, args, tmp_path, monkeypatch):
    # Every new entry point runs on the card by default, and never falls
    # back to the CPU on its own.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)
