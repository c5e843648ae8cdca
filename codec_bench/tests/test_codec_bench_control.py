"""The control comes out not correct, on the card at the cell's own size:
the program's bf16w mix, or the plain reference one step below the
stated precision put in the program's place (see ``calibrate``)."""

import pytest

from codec_bench import calibrate
from codec_bench.tests import helpers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["eae_learned_bw.serve", "eae_fixed_bw.ladder_train",
                                  "eae_learned_bw.train", "eae_fixed_bw.serve"])
def test_the_control_is_not_correct(cuda_device, cell, tmp_path):
    registry = helpers.checkout(str(tmp_path), tiny=False)
    context = calibrate.context_for(registry, cell, 2 ** 31 + 101, 2.0, cuda_device)
    serving = context.traffic["driver"] == "serve_requests"
    readings = (calibrate.serving_readings if serving else calibrate.training_readings)(
        context, "control")
    limits = registry.limits(cell)
    assert any(readings[name] > limit for (name, limit) in limits.items())
