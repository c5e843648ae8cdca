"""The readings each limit of ``limits/`` is set from, on the card.

    python3 -m codec_bench.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2

For each seed, in one process, at the cell's own size: the numbers
compared in a sound run of the program, then in the control's and (for
a training cell) in the faults'. One JSON line a reading. The
benchmark's own runs never run this.

- Control: the program's own lower-precision path where it has one (the
  configuration's ``serving.control``: "bf16w" for the learned
  architecture), else the plain reference one step below the precision
  the configuration states, put in the program's place: bf16 for fp32
  serving, TF32 for fp32-with-TF32-off training.
- Faults of a training cell, planted in the program: a step that
  returns its state unchanged, half of each batch left out (the mean
  taken over the rest), and the epoch's batch counter left unchanged
  (every replay trains on the epoch's first batch).
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy
import torch

from codec_bench import harness, training
from codec_bench.reference import codec, plain_fp32, rate, tf32


def half_batch(step_fns):
    """The fault "half of the batch left out": every step sees the first
    half of its batch, and its mean runs over that half."""
    from autoencoder_based_image_compression_tpu_torch.train.epoch_graph import epoch_fn

    step = step_fns["train_step"]

    def halved(state, batch, noise):
        return step(state, batch[:batch.shape[0] // 2], noise)

    return dict(step_fns, train_step=halved, train_epoch=epoch_fn(halved))


def unchanged(step_fns):
    """The fault "a step that returns its state unchanged"."""
    from autoencoder_based_image_compression_tpu_torch.train.state import clone_state

    def epoch(state, dataset, rows, noise):
        return clone_state(state)

    return dict(step_fns, train_epoch=epoch)


def stuck_counter(step_fns):
    """The fault "the epoch's batch counter left unchanged": every replay
    of an epoch gathers the epoch's first batch."""
    epoch = step_fns["train_epoch"]

    def stuck(state, dataset, rows, noise):
        rows = numpy.asarray(rows)
        return epoch(state, dataset, numpy.repeat(rows[:1], len(rows), axis=0), noise)

    return dict(step_fns, train_epoch=stuck)


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "stuck_counter": stuck_counter}


class ReferenceServer:
    """The plain reference put in the program's place as a server:
    ``images -> (reconstructions, bits)`` in ``dtype``, each distinct
    request computed once."""

    def __init__(self, context, dtype=torch.bfloat16):
        exp_dir = os.path.join(context.root, context.config["serving"]["artifact"])
        (self.params, self.bin_widths) = codec.load_params(
            os.path.join(exp_dir, "params_trained.npz"), torch.device(context.device))
        (self.map_mean, self.probabilities, self.idx_exception) = codec.load_statistics(exp_dir)
        (self.dtype, self.batch, self.cache) = (dtype, context.traffic["batch_size"], {})

    def __call__(self, images):
        key = hashlib.sha1(images.tobytes()).hexdigest()
        if key not in self.cache:
            (symbols, recs) = codec.roundtrip(self.params, self.bin_widths, self.map_mean,
                                              images, self.batch, self.dtype)
            self.cache[key] = (recs, rate.image_bits(symbols, self.probabilities,
                                                     self.idx_exception))
        return self.cache[key]


def context_for(registry, cell, seed, seconds, device="cuda"):
    entry = registry.cell(cell)
    return harness.Context(cell=cell, config=registry.config(entry["config"]),
                           traffic=registry.traffic(entry["traffic"]), seed=seed,
                           seconds=seconds, trace=False, device=device, started=time.time(),
                           root=registry.root)


def serving_readings(context, kind):
    """The numbers compared in a serving run of ``kind``: "sound" (the
    program as configured) or "control"."""
    driver = harness.Registry(context.root).driver(context.traffic["driver"])
    serve = None
    if kind == "control":
        control = context.config["serving"]["control"]
        if control.startswith("bf16w"):
            serve = driver.program(context, "bf16w")
        else:
            serve = ReferenceServer(context)
    run = driver.run(context, serve=serve)
    return dict(run.checks, attempted=run.attempted, failed=run.failed)


def training_readings(context, kind):
    """The numbers compared after the check steps of a training run of
    ``kind``: "sound", "control" (the reference in TF32 in the program's
    place) or a fault of :data:`FAULTS`."""
    ladder = context.traffic.get("ladder", False)
    prepared = training.Prepared(context, ladder, fault=FAULTS.get(kind))
    references = prepared.references(context.config)
    readings = prepared.readings
    if kind == "control":
        readings = training.reference_readings(prepared.references(context.config, tf32))
        plain_fp32()
    return training.compare(prepared.weights, readings, references)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on the card.", file=sys.stderr)
        return 2
    registry = harness.Registry()
    serving = registry.traffic(registry.cell(args.workload)["traffic"])["driver"] == (
        "serve_requests")
    kinds = [("sound", args.seeds), ("control", args.control_seeds)]
    if not serving:
        kinds += [(fault, args.control_seeds) for fault in FAULTS]
    for (kind, count) in kinds:
        for k in range(count):
            seed = args.first_seed + k
            context = context_for(registry, args.workload, seed, args.seconds)
            readings = (serving_readings if serving else training_readings)(context, kind)
            print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed, **readings}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
