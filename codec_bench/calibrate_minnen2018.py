"""The readings the joint-prior cell's limits are set from, on the card
(``limits/minnen2018_joint.train_rgb_joint.json``), as
``calibrate_hyperprior.py`` reads the hyperprior's.

    python3 -m codec_bench.calibrate_minnen2018 --seeds 12 --control-seeds 3

For each seed, in one process, at the cell's own size: the numbers
compared in a sound run of the program, in the control's (the plain
reference in TF32, one step below the configuration's fp32, in the
program's place) and in each fault's of ``codec_bench/calibrate.py``
(a step that returns its state unchanged, half of each batch left out,
the epoch's batch counter left unchanged). One JSON line a reading.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys

import torch

from codec_bench import calibrate, harness

CELL = "minnen2018_joint.train_rgb_joint"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_100_000_000)
    parser.add_argument("--kinds", nargs="*", default=None,
                        help="the kinds to read (default: sound, control and every fault)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on the card.", file=sys.stderr)
        return 2
    registry = harness.Registry()
    driver = registry.driver(registry.traffic(registry.cell(CELL)["traffic"])["driver"])
    kinds = [("sound", args.seeds), ("control", args.control_seeds)] + [
        (fault, args.control_seeds) for fault in sorted(calibrate.FAULTS)]
    for (kind, count) in kinds:
        if args.kinds is not None and kind not in args.kinds:
            continue
        for k in range(count):
            seed = args.first_seed + k
            context = calibrate.context_for(registry, CELL, seed, 0.0)
            readings = driver.readings(context, kind, calibrate.FAULTS)
            print(json.dumps({"cell": CELL, "kind": kind, "seed": seed, **readings}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
