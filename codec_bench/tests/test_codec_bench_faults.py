"""A run with the timed path broken underneath comes out not correct.

Each fault a cell can have, planted in the program at a tiny size on the
CPU, with the harness's own limits: an answer altered where it is
produced (a reconstruction, a bit count), half of a request's images
left out, a step that returns its state unchanged, half of each batch
left out with the mean taken over the rest, and an epoch whose batch
counter stays unchanged, so that every replay trains on its first
batch. (No cell runs across chips, so there is no exchange to leave
out.)"""

import numpy
import pytest

from codec_bench import calibrate, run
from codec_bench.tests import helpers

SERVE_CELLS = ["eae_learned_bw.serve", "eae_fixed_bw.serve"]
TRAIN_CELLS = [("eae_learned_bw.train", "step", "make_step_fns"),
               ("eae_fixed_bw.ladder_train", "ladder", "make_ladder_step_fns")]


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return helpers.tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


def _altered_reconstruction(recs, bits):
    recs = recs.copy()
    recs[0] = numpy.clip(recs[0].astype(int) + 8, 0, 255).astype(numpy.uint8)
    return (recs, bits)


def _altered_bits(recs, bits):
    bits = bits.copy()
    bits[-1] = int(bits[-1] * 1.01) + 1
    return (recs, bits)


def _half_the_images(recs, bits):
    return (recs[:len(recs) // 2], bits[:len(bits) // 2])


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", [_altered_reconstruction, _altered_bits, _half_the_images])
def test_a_broken_server_is_not_correct(registry, monkeypatch, cell, fault):
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )

    call = PipelinedCompressor.__call__
    monkeypatch.setattr(PipelinedCompressor, "__call__",
                        lambda self, images: fault(*call(self, images)))
    (line, _) = run.execute(registry, cell, 2 ** 31 + 21, 0.5, 0, "cpu", 0.0)
    assert line["correct"] is False


@pytest.mark.parametrize(("cell", "module", "factory"), TRAIN_CELLS)
@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_broken_training_step_is_not_correct(registry, monkeypatch, cell, module, factory,
                                               fault):
    import importlib

    program = importlib.import_module(
        f"autoencoder_based_image_compression_tpu_torch.train.{module}")
    make = getattr(program, factory)
    monkeypatch.setattr(program, factory,
                        lambda *args, **kwargs: calibrate.FAULTS[fault](make(*args, **kwargs)))
    (line, _) = run.execute(registry, cell, 2 ** 31 + 22, 0.3, 0, "cpu", 0.0)
    assert line["correct"] is False
