"""Training continuation with one fresh process a part, on the card
unless ``--device cpu`` is given.

Training is resumable part by part by design (the reference anticipates
cluster breakdowns, ``eae/graph/EntropyAutoencoder.py:13-17``): part p
starts from the finished checkpoints of part p-1. This runner uses that
to put each part in its own ``python -m
autoencoder_based_image_compression_tpu_torch.cli.<command>`` process,
which gives two things an in-process loop cannot: a hard limit on a
part (a process that stops writing checkpoints, or outlives its
timeout, is killed, whatever it waits on), and a clean restart from the
part checkpoints (a killed part's partial files are removed and the
part runs again in a new process, with a new CUDA context and the
kernel library loaded afresh from ``csrc/build/``).

Usage::

    python -m autoencoder_based_image_compression_tpu_torch.scripts.resilient_campaign \\
        --start_part 3 --end_part 11 [--nb_epochs 10] [--timeout 1500] [--device cuda]

Trains, for each part index p in [start, end]: the fixed-bw gamma
ladder (one ``cli/train_ladder`` process) and the learned-bin-width
sweep model (one ``cli/train_eae`` process). The learned-bw model is
brought level first if it lags behind.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

# The repository root: the children run ``python -m`` from there.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = "autoencoder_based_image_compression_tpu_torch"
GAMMAS = ["10000.0", "12000.0", "16000.0", "24000.0", "40000.0",
          "72000.0", "96000.0"]


def _exp_dir(results_root, bw_init, gamma, learn_bw):
    return os.path.join(results_root, experiment_suffix(float(bw_init), float(gamma), learn_bw))


def _part_complete(exp_dir, idx_model):
    npz = os.path.join(exp_dir, f"model_{idx_model}.npz")
    meta = os.path.join(exp_dir, f"model_{idx_model}.json")
    if not os.path.isfile(npz):
        return False
    if not os.path.isfile(meta):
        # npz written, meta not: the writer died mid-save (the meta is
        # written last) - treat as partial so _clean_partial sweeps it.
        return False
    with open(meta) as file:
        return bool(json.load(file).get("part_complete", True))


def _clean_partial(exp_dirs, idx_model):
    for exp_dir in exp_dirs:
        for ext in (".npz", ".json"):
            path = os.path.join(exp_dir, f"model_{idx_model}{ext}")
            if os.path.isfile(path):
                os.remove(path)
                print(f"[resilient] removed partial {path}", flush=True)


def _newest_mtime(exp_dirs, idx_model):
    newest = 0.0
    for exp_dir in exp_dirs:
        for ext in (".npz", ".json"):
            path = os.path.join(exp_dir, f"model_{idx_model}{ext}")
            if os.path.isfile(path):
                newest = max(newest, os.path.getmtime(path))
    return newest


def _run_part(argv_tail, exp_dirs, idx_model, timeout_s, label, retries=4,
              stall_s=180, cooldown_s=20, poll_s=15):
    """Runs one training part in a fresh ``python -m <argv_tail>``
    process from the repository root; cleans and retries on a stall, a
    timeout or a failure. Returns the seconds of the attempt that
    finished, or None when the part was already complete; raises
    ``RuntimeError`` after ``retries + 1`` failed attempts.

    Stall detection is progress-based: the training command lines save
    a checkpoint after every epoch, so ``stall_s`` seconds without a
    checkpoint write (checked every ``poll_s`` seconds) means the part
    makes no progress: it is killed and retried at once instead of
    waiting out ``timeout_s``. Start-up (imports, the CUDA context, the
    data upload) gets the same allowance from the process's start.
    ``cooldown_s`` is waited before each attempt.
    """
    if all(_part_complete(d, idx_model) for d in exp_dirs):
        print(f"[resilient] {label}: model_{idx_model} complete, skipping", flush=True)
        return None
    for attempt in range(retries + 1):
        _clean_partial(exp_dirs, idx_model)
        time.sleep(cooldown_s)
        t0 = time.time()
        print(f"[resilient] {label}: starting (attempt {attempt + 1})", flush=True)
        proc = subprocess.Popen([sys.executable, "-m"] + argv_tail, cwd=REPO)
        status = None
        while True:
            try:
                status = proc.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            now = time.time()
            last_progress = max(_newest_mtime(exp_dirs, idx_model), t0)
            if now - last_progress > stall_s:
                proc.kill()
                proc.wait()
                status = "stalled"
                break
            if now - t0 > timeout_s:
                proc.kill()
                proc.wait()
                status = "timeout"
                break
        took = time.time() - t0
        if status == 0 and all(_part_complete(d, idx_model) for d in exp_dirs):
            print(f"[resilient] {label}: done in {took:.0f} s", flush=True)
            return took
        print(f"[resilient] {label}: attempt {attempt + 1} failed "
              f"({status}, {took:.0f} s)", flush=True)
    raise RuntimeError(f"{label}: failed after {retries + 1} attempts")


def run_parts(start_part, end_part, common, results_root, timeout_s, cooldown_s=20):
    """Trains parts ``start_part..end_part``: for each, the learned-bw
    model brought level first when it lags, then the ladder part, then
    the learned-bw part, each through :func:`_run_part`. ``common`` is
    the arguments every child takes (epochs, batch, data, results root,
    device). Returns ``{label: seconds}`` of the parts that ran."""
    ladder_dirs = [_exp_dir(results_root, 1.0, g, False) for g in GAMMAS]
    learn_dir = _exp_dir(results_root, 0.5, 10000.0, True)
    cli = f"{PACKAGE}.cli"
    seconds = {}

    def run(argv_tail, exp_dirs, idx_model, label):
        took = _run_part(argv_tail + common, exp_dirs, idx_model, timeout_s, label,
                         cooldown_s=cooldown_s)
        if took is not None:
            seconds[label] = took

    for idx_part in range(start_part, end_part + 1):
        # Bring the learned-bw model level first when it lags (the
        # ladder's part finished but the learned-bw part did not).
        for lag in range(idx_part - 1, idx_part + 1):
            if (lag >= start_part - 1
                    and not _part_complete(learn_dir, lag + 1)
                    and _part_complete(learn_dir, lag)):
                run([f"{cli}.train_eae", "0.5", "10000.0", str(lag), "--learn_bin_widths"],
                    [learn_dir], lag + 1, f"learned-bw part {lag}")
        run([f"{cli}.train_ladder", "1.0", str(idx_part), "--gammas"] + GAMMAS, ladder_dirs,
            idx_part + 1, f"ladder part {idx_part}")
        run([f"{cli}.train_eae", "0.5", "10000.0", str(idx_part), "--learn_bin_widths"],
            [learn_dir], idx_part + 1, f"learned-bw part {idx_part}")
    return seconds


def common_args(nb_epochs, batch_size, data_root, results_root, device):
    """The arguments every child command line takes."""
    return ["--nb_epochs_training", str(nb_epochs),
            "--batch_size", str(batch_size),
            "--path_to_training_data", os.path.join(data_root, "training_data.npy"),
            "--path_to_validation_data", os.path.join(data_root, "validation_data.npy"),
            "--results_root", results_root,
            "--device", device]


def build_parser():
    parser = argparse.ArgumentParser(description="One fresh process a training part.")
    parser.add_argument("--start_part", type=int, required=True)
    parser.add_argument("--end_part", type=int, required=True)
    parser.add_argument("--nb_epochs", type=int, default=10)
    parser.add_argument("--timeout", type=int, default=1500)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--results_root", default="results/eae")
    parser.add_argument("--data_root", default="data/campaign")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; each child raises without a card) or "
                             "'cpu'; passed to every child")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # The children run from the repository root: relative paths are
    # made absolute here, against the caller's working directory.
    (data_root, results_root) = (os.path.abspath(args.data_root),
                                 os.path.abspath(args.results_root))
    run_parts(args.start_part, args.end_part,
              common_args(args.nb_epochs, args.batch_size, data_root, results_root,
                          args.device),
              results_root, args.timeout)


if __name__ == "__main__":
    main()
