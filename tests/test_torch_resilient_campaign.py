"""PyTorch port: the one-process-a-part training runner
(``<port>/scripts/resilient_campaign.py``) on the CPU, against the
reference package's ``scripts/resilient_campaign.py``.

``_run_part`` drives this file itself as its worker (``python -m
tests.test_torch_resilient_campaign <mode> <exp_dir> <idx> <marker>``,
the ``__main__`` block at the end): a worker that writes its part, one
that fails once and then writes it, and one that never writes a
checkpoint and is killed as stalled until the runner gives up. The
worker imports nothing heavy, so a process starts in well under a
second.
"""

import json
import os
import sys
import time

WORKER = "tests.test_torch_resilient_campaign"


def _worker(mode, exp_dir, idx_model, marker):
    """Writes ``model_<idx>.npz`` and a completed ``.json`` the way the
    training command lines do, after failing once (``fail_once``) or
    never (``never``: sleeps until it is killed)."""
    if mode == "never":
        time.sleep(600)
    if mode == "fail_once" and not os.path.isfile(marker):
        open(marker, "w").close()
        sys.exit(3)
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, f"model_{idx_model}")
    with open(path + ".npz", "wb") as file:
        file.write(b"weights")
    with open(path + ".json", "w") as file:
        json.dump({"step": 5, "part_complete": True}, file)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


import torch_cpu  # noqa: E402, F401  (first: this process's share of the cores)

import pytest  # noqa: E402

from autoencoder_based_image_compression_tpu_torch.scripts import (  # noqa: E402
    resilient_campaign,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    sys.path.insert(0, REPO)
    from scripts import resilient_campaign as jax_resilient_campaign

    return jax_resilient_campaign


def _run(tmp_path, mode, retries, stall_s=30):
    exp_dir = str(tmp_path / "exp")
    marker = str(tmp_path / "failed_once")
    return (exp_dir, resilient_campaign._run_part(
        [WORKER, mode, exp_dir, "2", marker], [exp_dir], 2, 120, f"worker {mode}",
        retries=retries, stall_s=stall_s, cooldown_s=0, poll_s=0.2))


def test_run_part_succeeds_at_the_first_attempt(tmp_path, capsys):
    (exp_dir, seconds) = _run(tmp_path, "ok", retries=0)
    assert seconds is not None and seconds < 60
    assert resilient_campaign._part_complete(exp_dir, 2)
    printed = capsys.readouterr().out
    assert "starting (attempt 1)" in printed and "attempt 2" not in printed
    # A complete part is not run again.
    assert resilient_campaign._run_part([WORKER, "never", exp_dir, "2", "x"], [exp_dir], 2,
                                        120, "again", cooldown_s=0, poll_s=0.2) is None


def test_run_part_retries_a_failed_worker(tmp_path, capsys):
    (exp_dir, seconds) = _run(tmp_path, "fail_once", retries=2)
    assert seconds is not None and resilient_campaign._part_complete(exp_dir, 2)
    printed = capsys.readouterr().out
    assert "attempt 1 failed (3," in printed and "starting (attempt 2)" in printed
    assert "attempt 3" not in printed


def test_run_part_kills_a_stalled_worker_and_gives_up(tmp_path, capsys):
    exp_dir = str(tmp_path / "exp")
    os.makedirs(exp_dir)
    with open(os.path.join(exp_dir, "model_2.npz"), "wb") as file:
        file.write(b"partial")  # an interrupted part's leftover: swept before each attempt
    t0 = time.time()
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        _run(tmp_path, "never", retries=1, stall_s=1.0)
    assert time.time() - t0 < 30
    printed = capsys.readouterr().out
    assert printed.count("(stalled,") == 2
    assert f"removed partial {os.path.join(exp_dir, 'model_2.npz')}" in printed
    assert not os.listdir(exp_dir)


def _layouts(root):
    """One experiment directory per case of a part's files on disk."""
    cases = {
        "nothing": {},
        "npz only": {"npz": b"w"},
        "json only": {"json": {"step": 3, "part_complete": True}},
        "interrupted": {"npz": b"w", "json": {"step": 3, "part_complete": False}},
        "complete": {"npz": b"w", "json": {"step": 3, "part_complete": True}},
        "unstamped": {"npz": b"w", "json": {"step": 3}},
    }
    dirs = {}
    for (name, files) in cases.items():
        exp_dir = os.path.join(root, name.replace(" ", "_"))
        os.makedirs(exp_dir)
        if "npz" in files:
            with open(os.path.join(exp_dir, "model_4.npz"), "wb") as file:
                file.write(files["npz"])
        if "json" in files:
            with open(os.path.join(exp_dir, "model_4.json"), "w") as file:
                json.dump(files["json"], file)
        with open(os.path.join(exp_dir, "model_3.npz"), "wb") as file:
            file.write(b"previous part")
        dirs[name] = exp_dir
    return dirs


def test_part_complete_and_clean_partial_agree_with_the_jax_script(tmp_path):
    jax_script = _jax_script()
    (port_dirs, jax_dirs) = (_layouts(str(tmp_path / "port")), _layouts(str(tmp_path / "jax")))
    for name in port_dirs:
        got = resilient_campaign._part_complete(port_dirs[name], 4)
        assert got == jax_script._part_complete(jax_dirs[name], 4), name
        assert got == (name in ("complete", "unstamped"))
        assert (resilient_campaign._newest_mtime([port_dirs[name]], 4) > 0) == (name != "nothing")
    resilient_campaign._clean_partial(list(port_dirs.values()), 4)
    jax_script._clean_partial(list(jax_dirs.values()), 4)
    for name in port_dirs:
        assert sorted(os.listdir(port_dirs[name])) == sorted(os.listdir(jax_dirs[name])) == [
            "model_3.npz"], name


def _recorder(learn_dir, calls):
    """A ``_run_part`` that records each call, skips a complete part as
    the real one does, and writes the learned model's part."""
    def run_part(argv_tail, exp_dirs, idx_model, timeout_s, label, **kwargs):
        if all(resilient_campaign._part_complete(d, idx_model) for d in exp_dirs):
            return None
        calls.append((argv_tail[0].rsplit(".", 1)[1], argv_tail[1:4], idx_model, label,
                      len(exp_dirs), timeout_s, kwargs, argv_tail[4:]))
        for exp_dir in exp_dirs:
            os.makedirs(exp_dir, exist_ok=True)
            for ext in (".npz", ".json"):
                with open(os.path.join(exp_dir, f"model_{idx_model}{ext}"), "w") as file:
                    file.write("{}")
        return 1.0
    return run_part


def _lagging_root(root):
    """Parts 0 and 1 of the ladder done, the learned model at part 0."""
    for (bw_init, gamma, learn_bw, parts) in [(0.5, 10000.0, True, (1,))] + [
            (1.0, g, False, (1, 2)) for g in resilient_campaign.GAMMAS]:
        exp_dir = resilient_campaign._exp_dir(root, bw_init, gamma, learn_bw)
        os.makedirs(exp_dir)
        for idx in parts:
            for ext in (".npz", ".json"):
                with open(os.path.join(exp_dir, f"model_{idx}{ext}"), "w") as file:
                    file.write("{}")
    return resilient_campaign._exp_dir(root, 0.5, 10000.0, True)


def test_run_parts_orders_the_parts_as_the_jax_script(tmp_path, monkeypatch):
    """Parts 1-2 with the learned-bw model a part behind the ladder: the
    learned model is brought level (its part 1, and its part 2 as soon
    as it is level), then the ladder's part 2, in the reference script's
    order; complete parts are skipped; every child gets the common
    arguments, ``--device`` among them."""
    jax_script = _jax_script()
    (port_root, jax_root) = (str(tmp_path / "port"), str(tmp_path / "jax"))
    (port_calls, jax_calls) = ([], [])
    monkeypatch.setattr(resilient_campaign, "_run_part",
                        _recorder(_lagging_root(port_root), port_calls))
    monkeypatch.setattr(jax_script, "_run_part", _recorder(_lagging_root(jax_root), jax_calls))
    common = resilient_campaign.common_args(2, 10, "data", port_root, "cpu")
    seconds = resilient_campaign.run_parts(1, 2, common, port_root, 99, cooldown_s=0)
    monkeypatch.setattr(sys, "argv", ["resilient_campaign.py", "--start_part", "1",
                                      "--end_part", "2", "--timeout", "99", "--nb_epochs", "2",
                                      "--results_root", jax_root, "--data_root", "data"])
    jax_script.main()
    assert [call[3] for call in port_calls] == [call[3] for call in jax_calls] == [
        "learned-bw part 1", "learned-bw part 2", "ladder part 2"]
    assert [call[:3] for call in port_calls] == [call[:3] for call in jax_calls]
    assert port_calls[0][:3] == ("train_eae", ["0.5", "10000.0", "1"], 2)
    assert port_calls[2][:3] == ("train_ladder", ["1.0", "2", "--gammas"], 3)
    assert port_calls[2][4] == len(resilient_campaign.GAMMAS) == 7
    for (port, jax_call) in zip(port_calls, jax_calls):
        assert port[5] == jax_call[5] == 99 and port[6] == {"cooldown_s": 0}
        assert port[7] == jax_call[7][:port[7].index("--path_to_training_data")] + port[7][
            port[7].index("--path_to_training_data"):]
        assert port[7][-2:] == ["--device", "cpu"]
    assert list(seconds) == [call[3] for call in port_calls]


def test_device_is_passed_to_every_child_of_main(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(resilient_campaign, "run_parts",
                        lambda *args, **kwargs: seen.append((args, kwargs)))
    resilient_campaign.main(["--start_part", "0", "--end_part", "0", "--results_root",
                             str(tmp_path / "r"), "--data_root", str(tmp_path / "d")])
    ((args, _),) = seen
    common = args[2]
    assert common[-2:] == ["--device", "cuda"]
    assert common[common.index("--path_to_training_data") + 1] == str(
        tmp_path / "d" / "training_data.npy")
