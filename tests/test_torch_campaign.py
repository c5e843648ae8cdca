"""PyTorch port: the Kodak rate-distortion campaign
(``<port>/scripts/rd_campaign.py``) on the CPU, against the reference
package's ``scripts/rd_campaign.py``.

A micro campaign through the port's command line asserts what the
reference's micro campaign test asserts (``tests/test_rd_campaign.py``);
the stages are held one by one: the data stacks byte-equal to the
reference script's, the finished-part check, the stale-statistics sweep,
and exports that the reference package loads. The finalisation script's
commands all parse their arguments.
"""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu_torch.scripts import rd_campaign
from autoencoder_based_image_compression_tpu_torch.train import checkpoint as tck
from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "autoencoder_based_image_compression_tpu_torch"
FINALIZE = os.path.join(REPO, PORT, "scripts", "finalize_study.sh")


def _jax_script():
    sys.path.insert(0, REPO)
    from scripts import rd_campaign as jax_rd_campaign

    return jax_rd_campaign


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """The port's micro campaign, run as a user runs it; returns
    ``(tmp root, its standard output)``. ``--gammas`` leaves 10000 out on
    purpose: the fixed-bin-width sweep model is trained all the same."""
    tmp = tmp_path_factory.mktemp("campaign")
    result = subprocess.run(
        [sys.executable, "-m", f"{PORT}.scripts.rd_campaign", "--smoke", "--gammas", "12000",
         "--ladder_vmap", "--device", "cpu", "--data_root", str(tmp / "data"),
         "--results_root", str(tmp / "results"), "--out", str(tmp / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stdout + result.stderr
    return (tmp, result.stdout)


def test_micro_campaign(campaign):
    (tmp, printed) = campaign
    out = tmp / "out"
    assert (out / "rate_distortion.png").is_file(), printed
    # Three EAE curve families (the ladder and both sweeps) were
    # evaluated and cached.
    assert len(list(out.glob("*.npy"))) >= 6, printed
    assert "one stacked ladder state through cli/train_ladder" in printed
    for gamma_dir in ("1_10000", "1_12000"):
        assert (tmp / "results" / "fixed_bw" / gamma_dir / "model_1.npz").is_file()
    # Params-only exports of both sweep models, step-stamped like the
    # statistics' markers.
    for exp in ("learning_bw/0dot5_10000", "fixed_bw/1_10000"):
        artifact = tmp / "results" / exp / "params_trained.npz"
        step = tck.params_artifact_step(str(artifact))
        assert step is not None and step > 0
        marker = tmp / "results" / exp / "statistics" / "stats_model_idx.json"
        assert json.loads(marker.read_text()) == {"idx_model": 1, "step": step}


def test_second_call_trains_nothing(campaign, capsys):
    """A rerun over the same roots skips every part and the statistics
    and reads every curve from the caches."""
    (tmp, _) = campaign
    mtimes = {path: path.stat().st_mtime_ns for path in (tmp / "results").rglob("model_*")}
    rd_campaign.main(["--smoke", "--gammas", "12000", "--ladder_vmap", "--device", "cpu",
                      "--data_root", str(tmp / "data"), "--results_root", str(tmp / "results"),
                      "--out", str(tmp / "out")])
    printed = capsys.readouterr().out
    assert "ladder: part 0 exists for all gammas, skipping" in printed
    assert "model_1 exists, skipping training" in printed
    assert printed.count("statistics for model_1 exist, skipping") == 2
    assert mtimes == {path: path.stat().st_mtime_ns
                      for path in (tmp / "results").rglob("model_*")}


def test_build_data_is_byte_equal_to_the_jax_script(tmp_path):
    jax_rd_campaign = _jax_script()
    config = (4, 2, 3, 32, (2, 64, 96))
    port = rd_campaign.build_data(str(tmp_path / "port"), *config)
    jax_paths = jax_rd_campaign.build_data(str(tmp_path / "jax"), *config)
    assert set(port) == set(jax_paths) == {"training", "validation", "extra", "kodak"}
    for role in port:
        (got, expected) = (numpy.load(port[role]), numpy.load(jax_paths[role]))
        assert got.dtype == expected.dtype == numpy.uint8
        assert got.shape == expected.shape and got.tobytes() == expected.tobytes(), role
    # A stale stack of another shape is regenerated, not reused.
    rd_campaign.build_data(str(tmp_path / "port"), 6, 2, 3, 16, (2, 32, 48))
    assert numpy.load(port["training"]).shape == (6, 16, 16, 1)
    assert numpy.load(port["kodak"]).shape == (2, 32, 48)


def _state(seed=0, bin_width_init=1.0, learn_bin_widths=False):
    return init_train_state(torch.Generator().manual_seed(seed), bin_width_init,
                            learn_bin_widths, device="cpu")


def test_part_done_rejects_interrupted_checkpoints(tmp_path, capsys):
    path = str(tmp_path / "model_1")
    tck.save_checkpoint(path, _state())
    assert not rd_campaign._part_done(path)  # interrupted: removed...
    assert "interrupted part detected" in capsys.readouterr().out
    assert not os.path.isfile(path + ".npz") and not os.path.isfile(path + ".json")
    tck.save_checkpoint(path, _state())
    tck.mark_checkpoint_complete(path)
    assert rd_campaign._part_done(path)  # ...finished: accepted


def test_part_done_removes_orphan_metadata(tmp_path, capsys):
    path = str(tmp_path / "model_2")
    with open(path + ".json", "w") as file:
        json.dump({"step": 7, "part_complete": True}, file)
    assert not rd_campaign._part_done(path)
    assert "orphan checkpoint metadata" in capsys.readouterr().out
    assert not os.path.isfile(path + ".json")


def test_stale_statistics_are_deleted_before_recollection(tmp_path, monkeypatch):
    root = tmp_path / "results"
    exp_dir = root / "fixed_bw" / "1_10000"
    stats_dir = exp_dir / "statistics"
    stats_dir.mkdir(parents=True)
    stale = ["map_mean.npy", "idx_map_exception.pkl", "binary_probabilities_1.npy",
             "binary_probabilities_99.npy"]
    for name in stale:
        (stats_dir / name).write_bytes(b"stale")
    (stats_dir / "stats_model_idx.json").write_text(json.dumps({"idx_model": 1, "step": 3}))
    state = _state()._replace(step=torch.tensor(41, dtype=torch.int32))
    tck.save_checkpoint(str(exp_dir / "model_2"), state)
    seen = []

    def collect(argv):
        seen.append((argv, sorted(os.listdir(stats_dir))))
        (stats_dir / "map_mean.npy").write_bytes(b"new")

    monkeypatch.setattr(rd_campaign.cs, "main", collect)
    paths = {"extra": str(tmp_path / "extra.npy")}
    rd_campaign.collect_stats(str(root), paths, 1.0, 10000.0, False, 2, "cpu")
    ((argv, listed),) = seen
    assert listed == ["stats_model_idx.json"]  # every stale table was gone
    assert argv[:3] == ["1.0", "10000.0", "2"] and argv[-2:] == ["--device", "cpu"]
    assert json.loads((stats_dir / "stats_model_idx.json").read_text()) == {
        "idx_model": 2, "step": 41}
    # The same model index again: nothing is recollected.
    rd_campaign.collect_stats(str(root), paths, 1.0, 10000.0, False, 2, "cpu")
    assert len(seen) == 1


def test_exports_load_through_the_jax_loader(tmp_path):
    from autoencoder_based_image_compression_tpu.train.checkpoint import load_params_artifact

    root = tmp_path / "results"
    states = {}
    for (seed, (bw_init, gamma, learn_bw)) in enumerate(
            [rd_campaign.LEARNED, (1.0, 10000.0, False), (1.0, 24000.0, False)]):
        state = _state(seed, bw_init, learn_bw)._replace(
            step=torch.tensor(100 + seed, dtype=torch.int32))
        suffix = experiment_suffix(bw_init, gamma, learn_bw)
        tck.save_checkpoint(str(root / suffix / "model_3"), state)
        states[suffix] = state
    rd_campaign.export_params(str(root), [24000.0, 10000.0], 3, "cpu")
    for (suffix, state) in states.items():
        path = str(root / suffix / "params_trained.npz")
        (params, bin_widths) = load_params_artifact(path)
        expected = tck.params_to_jax(state.params)
        assert set(params) == set(expected)
        for (name, value) in expected.items():
            assert numpy.asarray(params[name]).dtype == value.dtype
            numpy.testing.assert_array_equal(numpy.asarray(params[name]), value, err_msg=name)
        numpy.testing.assert_array_equal(numpy.asarray(bin_widths),
                                         state.bin_widths.numpy())
        assert tck.params_artifact_step(path) == int(state.step)


def test_evaluation_argv_passes_the_device_and_the_anchor_flags():
    args = rd_campaign.parse_args(["--smoke", "--nb_parts", "3", "--jpeg2000_ladder", "20",
                                   "10", "--hevc_encoder", "hm", "--hevc_qps", "22", "27",
                                   "--device", "cpu"])
    assert (args.crop, args.kodak_shape, args.nb_epochs) == (64, (4, 128, 192), 2)
    assert (args.nb_training, args.nb_validation, args.nb_extra) == (40, 20, 20)
    assert args.gammas_trained == rd_campaign.GAMMAS_VARY
    argv = rd_campaign.evaluation_argv(args, {"kodak": "k.npy"})
    assert argv == ["--idx_training", "3", "--code_lossless", "--path_to_kodak", "k.npy",
                    "--results_root", "results/eae", "--cache_dir", "results/eae/kodak_rd",
                    "--device", "cpu", "--hevc_encoder", "hm", "--hevc_qps", "22", "27",
                    "--jpeg2000_backend", "pillow", "--jpeg2000_ladder", "20.0", "10.0"]
    assert rd_campaign.parse_args(["--gammas", "40000"]).gammas_trained == [40000.0, 10000.0]


def test_finalize_script_parses_and_its_commands_take_their_arguments():
    subprocess.run(["bash", "-n", FINALIZE], check=True, timeout=30)
    with open(FINALIZE) as file:
        text = file.read()
    commands = [[sys.executable, "-m", f"{PORT}.{module}"] for module in
                ("scripts.rd_campaign", "cli.reconstruct_kodak", "scripts.stability_study")]
    commands.append([sys.executable, os.path.join(REPO, "bench_torch.py")])
    for module in ("scripts.rd_campaign", "cli.reconstruct_kodak", "scripts.stability_study"):
        assert f"$PKG.{module}" in text
    assert "bench_torch.py" in text and "--nb_parts" in text and "--use_bsds" in text
    assert "--k 3" in text
    for command in commands:
        result = subprocess.run(command + ["--help"], cwd=REPO, capture_output=True, text=True,
                                timeout=120)
        assert result.returncode == 0 and "usage:" in result.stdout, result.stderr
        assert "--device" in result.stdout
