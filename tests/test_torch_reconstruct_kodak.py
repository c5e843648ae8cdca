"""PyTorch port: the rate-distortion evaluation command line
(``cli/reconstruct_kodak``) on the CPU against the JAX package's, on the
same 4 x 64 x 96 image stack and the trained models and statistics
committed under ``results/eae`` (read only; every output goes to a
temporary cache directory), anchors through Pillow.

Both command lines must write the same curve files and the same
``dictionary_bjontegaard.pkl`` keys; PSNRs agree within 0.01 dB, rates
within 1 % (equal where no symbol flips), the anchors exactly (the same
Pillow on the same images), the Bjontegaard savings within 0.5 points.
"""

import os
import pickle

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.cli import reconstruct_kodak as jax_reconstruct_kodak
from autoencoder_based_image_compression_tpu_torch.cli import reconstruct_kodak
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results", "eae")
LADDER = ["40", "24", "12", "6", "3"]


def _run(main, tmp, name, images_path, *extra):
    cache_dir = str(tmp / name)
    main(["--code_lossless", "--path_to_kodak", images_path, "--results_root", RESULTS,
          "--cache_dir", cache_dir, "--batch_size", "2", *extra])
    return cache_dir


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Both command lines on the same stack; ``(port dir, JAX dir)``."""
    tmp = tmp_path_factory.mktemp("rd")
    images_path = str(tmp / "kodak.npy")
    numpy.save(images_path, synthetic_luminance_stack(4, 64, 96, seed=3)[..., 0])
    anchors = ["--jpeg2000_backend", "pillow", "--jpeg2000_ladder", *LADDER]
    port = _run(reconstruct_kodak.main, tmp, "port", images_path, "--device", "cpu", *anchors)
    jax_dir = _run(jax_reconstruct_kodak.main, tmp, "jax", images_path, *anchors)
    return (port, jax_dir)


def test_same_curve_files_as_the_jax_cli(study):
    (port, jax_dir) = study
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_dir))
    assert sum(name.endswith(".npy") for name in names) == 2 + 3 + 3 + 2
    for name in ("rate_distortion.png", "nb_dead_learn_bw.png", "nb_dead_fixed_bw.png",
                 "dictionary_bjontegaard.pkl"):
        assert name in names and os.path.getsize(os.path.join(port, name)) > 0
    assert ("rates_vary_gamma_g10000s88307-12000s88307-16000s88307-24000s88307-40000s88307-"
            "72000s88307-96000s88074.npy") in names
    assert ("deads_fix_gamma_learn_0dot5_10000_s83880_m1-1dot25-1dot5-2-3-4-6-8-10_coded.npy"
            in names)


def test_curve_values_agree_with_the_jax_cli(study):
    (port, jax_dir) = study
    for name in sorted(os.listdir(port)):
        if not name.endswith(".npy"):
            continue
        (got, expected) = (numpy.load(os.path.join(port, name)),
                           numpy.load(os.path.join(jax_dir, name)))
        assert got.shape == expected.shape and got.dtype == expected.dtype, name
        if "jpeg2000" in name:
            numpy.testing.assert_array_equal(got, expected, err_msg=name)
        elif name.startswith("psnrs"):
            assert numpy.abs(got - expected).max() <= 0.01, name
        elif name.startswith("rates"):
            numpy.testing.assert_allclose(got, expected, rtol=0.01, err_msg=name)
        else:
            assert numpy.mean(got == expected) >= 0.99, name


def test_bjontegaard_dictionary_has_the_jax_cli_keys_and_values(study):
    (port, jax_dir) = study
    with open(os.path.join(port, "dictionary_bjontegaard.pkl"), "rb") as file:
        got = pickle.load(file)
    with open(os.path.join(jax_dir, "dictionary_bjontegaard.pkl"), "rb") as file:
        expected = pickle.load(file)
    assert set(got) == set(expected) and got
    assert all(key.startswith("EAE") and key.endswith("vs JPEG2000") for key in got)
    for (key, summary) in expected.items():
        assert set(got[key]) == {"delta_pct", "fit_quality"}
        assert abs(got[key]["delta_pct"] - summary["delta_pct"]) <= 0.5, key
        assert got[key]["fit_quality"]["reliable"] == summary["fit_quality"]["reliable"]


def test_second_run_reads_the_cache_of_either_package(study, capsys, monkeypatch):
    (_, jax_dir) = study
    images_path = os.path.join(os.path.dirname(jax_dir), "kodak.npy")
    before = {name: os.path.getmtime(os.path.join(jax_dir, name))
              for name in os.listdir(jax_dir) if name.endswith(".npy")}
    # Over the JAX package's cache directory nothing is encoded again.
    monkeypatch.setattr(reconstruct_kodak.rd_sweep, "compute_rate_psnr", None)
    reconstruct_kodak.main(["--code_lossless", "--path_to_kodak", images_path, "--results_root",
                            RESULTS, "--cache_dir", jax_dir, "--batch_size", "2", "--device",
                            "cpu", "--jpeg2000_backend", "pillow", "--jpeg2000_ladder", *LADDER])
    assert "4 RD curves written" in capsys.readouterr().out
    for (name, mtime) in before.items():
        assert os.path.getmtime(os.path.join(jax_dir, name)) == mtime, name


@pytest.mark.parametrize("ladder,backend_args,tag", [
    ([], [], "600-400-300-220-160-120-80-64-48-32-24-16-12-8"),
    (["20", "10"], [], "20-10"),
], ids=["bare", "explicit_under_auto"])
def test_jpeg2000_ladder_argument(tmp_path, capsys, ladder, backend_args, tag):
    """A bare ``--jpeg2000_ladder`` means the default ladder; explicit
    values without a backend pin Pillow and say so. No trained model is
    found under the empty results root: only the anchor is computed."""
    from autoencoder_based_image_compression_tpu_torch.codecs.jpeg2000 import (
        imagemagick_available,
    )

    images_path = str(tmp_path / "kodak.npy")
    numpy.save(images_path, synthetic_luminance_stack(2, 64, 96, seed=4)[..., 0])
    cache_dir = str(tmp_path / "cache")
    reconstruct_kodak.main(["--path_to_kodak", images_path, "--results_root",
                            str(tmp_path / "none"), "--cache_dir", cache_dir, "--device", "cpu",
                            "--jpeg2000_ladder", *ladder, *backend_args])
    printed = capsys.readouterr().out
    assert ("interpreting the values as Pillow/OpenJPEG compression ratios" in printed) \
        == bool(ladder)
    if ladder or not imagemagick_available():
        names = [name for name in os.listdir(cache_dir) if name.startswith("rates_jpeg2000")]
        assert len(names) == 1 and names[0].startswith(f"rates_jpeg2000_pillow_{tag}_")
        assert numpy.load(os.path.join(cache_dir, names[0])).shape == (2, len(tag.split("-")))
    assert "1 RD curves written" in printed


def test_load_state_prefers_the_checkpoint_and_falls_back_to_the_export(tmp_path, capsys):
    root = str(tmp_path)
    exp_dir = os.path.join(root, "fixed_bw", "1_10000")
    assert reconstruct_kodak._load_state(root, 1.0, 10000.0, False, 1, "cpu") is None
    state = init_train_state(torch.Generator().manual_seed(5), 1.0, False, device="cpu")
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    # An export without a step stamp: the cache token is a content hash.
    tck.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"), state.params,
                             state.bin_widths)
    model = reconstruct_kodak._load_state(root, 1.0, 10000.0, False, 1, torch.device("cpu"))
    assert "using the params export" in capsys.readouterr().out
    assert isinstance(model.step, str) and model.step.startswith("x") and len(model.step) == 11
    assert reconstruct_kodak._step_key(model.step) == model.step
    assert torch.equal(model.params["weights_2"], state.params["weights_2"])
    assert model.bin_widths.dtype == numpy.float32 and model.bin_widths.shape == (128,)
    # With a stamp: the step. With a checkpoint beside it: the checkpoint.
    tck.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"), state.params,
                             state.bin_widths, step=3)
    model = reconstruct_kodak._load_state(root, 1.0, 10000.0, False, 1, torch.device("cpu"))
    assert reconstruct_kodak._step_key(model.step) == "3"
    tck.save_checkpoint(os.path.join(exp_dir, "model_1"), state)
    model = reconstruct_kodak._load_state(root, 1.0, 10000.0, False, 1, torch.device("cpu"))
    assert reconstruct_kodak._step_key(model.step) == "7"
    assert torch.equal(model.params["gamma_3"], state.params["gamma_3"])


def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        reconstruct_kodak.main(["--path_to_kodak", str(tmp_path / "none.npy")])


def test_compute_alone_writes_every_cache_file_and_no_figure(study, monkeypatch):
    """The compute half writes what ``main`` writes but the figures, and
    returns the curves and summaries the figures and the pickle are made
    from; it never imports matplotlib. ``main`` draws the three figures
    from that result (``test_same_curve_files_as_the_jax_cli``)."""
    import sys

    (port, _) = study
    images_path = os.path.join(os.path.dirname(port), "kodak.npy")
    cache_dir = os.path.join(os.path.dirname(port), "compute_only")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # importing it raises
    result = reconstruct_kodak.compute(
        ["--code_lossless", "--path_to_kodak", images_path, "--results_root", RESULTS,
         "--cache_dir", cache_dir, "--batch_size", "2", "--device", "cpu",
         "--jpeg2000_backend", "pillow", "--jpeg2000_ladder", *LADDER])
    names = sorted(os.listdir(cache_dir))
    assert names == sorted(name for name in os.listdir(port) if not name.endswith(".png"))
    assert "dictionary_bjontegaard.pkl" in names
    with open(os.path.join(cache_dir, "dictionary_bjontegaard.pkl"), "rb") as file:
        assert set(pickle.load(file)) == set(result.summaries)
    assert [label for (_, _, label, _) in result.curves] == [
        "EAE one model per gamma", "EAE learned bin widths", "EAE fixed bin widths", "JPEG2000"]
    assert set(result.families) == {label for (_, _, label, _) in result.curves[:3]}
    assert [len(result.families[label]) for (_, _, label, _) in result.curves[:3]] == [2, 3, 3]
    assert result.cache_dir == cache_dir and result.title == "Rate-distortion on Kodak"
    for (name, array) in (("psnrs", result.families["EAE learned bin widths"][1]),
                          ("deads", result.families["EAE learned bin widths"][2])):
        (path,) = [n for n in names if n.startswith(f"{name}_fix_gamma_learn")]
        numpy.testing.assert_array_equal(numpy.load(os.path.join(cache_dir, path)), array)
