"""PyTorch port: the checkpoint-averaging stability study
(``<port>/scripts/stability_study.py``) on the CPU, against the reference
package's ``scripts/stability_study.py``.

The averages are held bit for bit against the reference script's on the
same port checkpoints (the reference loader reads them); a whole run on
a small image stack writes the comparison with the reference script's
keys, from checkpoints made of the committed trained models.
"""

import json
import os
import sys

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.cli import reconstruct_kodak
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.scripts import stability_study
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results", "eae")
COMMITTED = os.path.join(RESULTS, "kodak_rd_stability", "stability_comparison.json")


def _template(seed=0):
    return init_train_state(torch.Generator().manual_seed(seed), 1.0, False, device="cpu")


def _write_part(exp_dir, idx, state, complete=True):
    path = os.path.join(exp_dir, f"model_{idx}")
    tck.save_checkpoint(path, state)
    if complete:
        tck.mark_checkpoint_complete(path)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Three complete parts and a fourth interrupted one for two gammas,
    each part with other random weights and a later step."""
    root = tmp_path_factory.mktemp("parts")
    for (g, gamma) in enumerate((10000.0, 24000.0)):
        exp_dir = str(root / experiment_suffix(1.0, gamma, False))
        for idx in (1, 2, 3, 4):
            state = _template(10 * g + idx)._replace(
                step=torch.tensor(100 * idx + g, dtype=torch.int32))
            _write_part(exp_dir, idx, state, complete=idx < 4)
    return root


@pytest.mark.parametrize("gamma", [10000.0, 24000.0])
@pytest.mark.parametrize("k", [3, 2])
def test_average_equals_the_jax_script_bit_for_bit(parts, gamma, k):
    sys.path.insert(0, REPO)
    from scripts import stability_study as jax_stability_study

    exp_dir = str(parts / experiment_suffix(1.0, gamma, False))
    assert stability_study._complete_part_indices(exp_dir) == [1, 2, 3]  # part 4 interrupted
    (mean, bin_widths, step, used) = stability_study.average_gamma_params(exp_dir, gamma, k,
                                                                          device="cpu")
    (mean_jax, bin_widths_jax, step_jax, used_jax) = jax_stability_study.average_gamma_params(
        exp_dir, gamma, k)
    assert used == used_jax == [1, 2, 3][-k:]
    assert step == step_jax == 100 * 3 + (gamma == 24000.0)
    numpy.testing.assert_array_equal(bin_widths, numpy.asarray(bin_widths_jax))
    assert set(mean) == set(mean_jax)
    for (name, value) in mean.items():
        expected = numpy.asarray(mean_jax[name])
        assert value.dtype == expected.dtype == numpy.float32
        assert value.shape == expected.shape and value.tobytes() == expected.tobytes(), name


def test_no_complete_part_raises(tmp_path):
    exp_dir = str(tmp_path / "fixed_bw" / "1_10000")
    _write_part(exp_dir, 1, _template(), complete=False)
    with pytest.raises(FileNotFoundError, match="no complete checkpoints"):
        stability_study.average_gamma_params(exp_dir, 10000.0, 3, device="cpu")


def test_main_writes_the_comparison_with_the_jax_scripts_keys(tmp_path, capsys):
    """Two complete parts of each committed per-gamma model: the average
    is the model itself, so both sides of the comparison agree."""
    results = tmp_path / "results"
    for gamma in stability_study.GAMMAS:
        suffix = experiment_suffix(1.0, gamma, False)
        artifact = os.path.join(RESULTS, suffix, "params_trained.npz")
        (params_np, bin_widths) = tck.load_params_artifact(artifact)
        state = _template()._replace(
            params=tck.params_from_jax(params_np),
            step=torch.tensor(tck.params_artifact_step(artifact), dtype=torch.int32))
        for idx in (1, 2):
            _write_part(str(results / suffix), idx, state)
    kodak = str(tmp_path / "kodak.npy")
    numpy.save(kodak, synthetic_luminance_stack(4, 128, 192, seed=3)[..., 0])
    study_dir = str(tmp_path / "study")
    # The main study (the last-checkpoint side) on the committed models.
    reconstruct_kodak.compute(["--path_to_kodak", kodak, "--results_root", RESULTS,
                               "--cache_dir", study_dir, "--device", "cpu"])
    (avg_root, out) = (str(tmp_path / "avg"), str(tmp_path / "out"))
    stability_study.main(["--k", "2", "--results_root", str(results), "--avg_root", avg_root,
                          "--study_dir", study_dir, "--out", out, "--path_to_kodak", kodak,
                          "--hevc_encoder", "", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "averaged parts [1, 2]" in printed and "using the params export" in printed
    for gamma in stability_study.GAMMAS:
        suffix = experiment_suffix(1.0, gamma, False)
        (got, _) = tck.load_params_artifact(os.path.join(avg_root, suffix, "params_trained.npz"))
        (expected, _) = tck.load_params_artifact(os.path.join(RESULTS, suffix,
                                                              "params_trained.npz"))
        assert all(numpy.array_equal(got[name], expected[name]) for name in expected)
    # The anchor caches were copied, not recomputed.
    anchors = sorted(name for name in os.listdir(study_dir) if "_jpeg2000_" in name)
    assert anchors and set(anchors) <= set(os.listdir(out))
    with open(os.path.join(out, "stability_comparison.json")) as file:
        comparison = json.load(file)
    with open(COMMITTED) as file:
        committed = json.load(file)
    assert set(comparison) == set(committed), printed
    assert set(comparison["averaged_parts"]) == set(committed["averaged_parts"])
    assert all(used == [1, 2] for used in comparison["averaged_parts"].values())
    key = "EAE one model per gamma vs JPEG2000"
    assert set(comparison["last_checkpoint"]) == set(comparison["k_checkpoint_average"]) == {key}
    assert comparison["k_checkpoint_average"][key] == comparison["last_checkpoint"][key]
    assert os.path.isfile(os.path.join(out, "rate_distortion.png"))
