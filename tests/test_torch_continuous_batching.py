"""PyTorch port: the continuous batcher on the CPU (the single-device
cases of tests/test_continuous_batching.py) and stream_roundtrip against
the JAX package's."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import os
import threading

import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.parallel.continuous_batching import (
    stream_roundtrip as jax_stream_roundtrip,
)
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.parallel.continuous_batching import (
    ContinuousBatcher,
    stream_roundtrip,
)
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    roundtrip_batched,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000",
                       "params_trained.npz")


def test_batcher_packs_and_pads():
    calls = []

    def batch_fn(batch):
        calls.append(batch.numpy().copy())
        return batch * 2.0

    batcher = ContinuousBatcher(batch_fn, batch_size=4)
    for i in range(10):  # 2 full batches + 1 partial of 2
        batcher.submit(i, numpy.full((3, 3), float(i), numpy.float32))
    results = batcher.flush()
    assert len(calls) == 3
    assert all(c.shape == (4, 3, 3) for c in calls)
    assert numpy.all(calls[2][2:] == 0.0)  # the padding of the last batch
    assert sorted(results) == list(range(10))
    for i in range(10):
        numpy.testing.assert_allclose(results[i], 2.0 * i)
    assert batcher.flush() == {}


def test_batcher_completion_callback():
    delivered = {}
    batcher = ContinuousBatcher(
        lambda batch: batch + 1.0, batch_size=4, max_in_flight=1,
        on_complete=lambda image_id, out: delivered.setdefault(image_id, out))
    for i in range(9):  # 2 full batches + 1 partial of 1
        batcher.submit(i, numpy.full((2, 2), float(i), numpy.float32))
    assert batcher.flush() == {}
    assert sorted(delivered) == list(range(9))
    for i in range(9):
        assert isinstance(delivered[i], numpy.ndarray)
        numpy.testing.assert_allclose(delivered[i], i + 1.0)


def test_batcher_concurrent_producers():
    """Several submit threads: every image delivered exactly once, and
    every batch function call made under the device lock."""
    inside = []
    overlap = []

    def batch_fn(batch):
        inside.append(1)
        overlap.append(len(inside))
        out = batch * 3.0
        inside.pop()
        return out

    batcher = ContinuousBatcher(batch_fn, batch_size=4, max_in_flight=2)

    def producer(base):
        for i in range(base, base + 25):
            batcher.submit(i, numpy.full((2,), float(i), numpy.float32))

    threads = [threading.Thread(target=producer, args=(k * 25,)) for k in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive()
    results = batcher.flush()
    assert sorted(results) == list(range(100))
    for i in range(100):
        numpy.testing.assert_allclose(results[i], 3.0 * i)
    assert len(overlap) == 25 and max(overlap) == 1


def test_batcher_bounds_in_flight():
    batcher = ContinuousBatcher(lambda batch: batch + 1.0, batch_size=2, max_in_flight=1)
    for i in range(8):
        batcher.submit(i, numpy.zeros((2, 2), numpy.float32))
        assert len(batcher._in_flight) <= 1
    assert len(batcher.flush()) == 8


def test_stream_roundtrip_matches_batched():
    (params_np, bin_widths) = load_params_artifact(LEARNED)
    params = params_from_jax(params_np)
    images = synthetic_luminance_stack(6, 32, 32, seed=1)
    streamed = stream_roundtrip(params, bin_widths, images, batch_size=4, device="cpu")
    assert streamed.shape == (6, 32, 32, 1) and streamed.dtype == numpy.float32
    batched = roundtrip_batched(params, images[:4], bin_widths, True, batch_size=4,
                                device="cpu")
    # The first batch holds the same four images in both: equal.
    numpy.testing.assert_array_equal(streamed[:4], batched)


def test_stream_roundtrip_matches_jax():
    (params_jax, bin_widths) = jax_load_params_artifact(LEARNED)
    (params_np, _) = load_params_artifact(LEARNED)
    images = synthetic_luminance_stack(6, 32, 48, seed=2)
    expected = jax_stream_roundtrip(params_jax, numpy.asarray(bin_widths), images,
                                    batch_size=4)
    got = stream_roundtrip(params_from_jax(params_np), bin_widths, images, batch_size=4,
                           max_in_flight=1, device="cpu")
    assert got.shape == expected.shape == (6, 32, 48, 1)
    # fp32 on both sides. A latent within ~1e-5 of a rounding boundary
    # may quantise the other way, which moves the pixels around it by
    # far more than summation order does: all but 1e-3 of the pixels
    # within the fp32 decode's tolerance, every image above 60 dB.
    close = numpy.isclose(got, expected, rtol=1e-5, atol=1e-3)
    print("share of pixels within rtol 1e-5 / atol 1e-3:", close.mean())
    assert close.mean() >= 1.0 - 1e-3
    for i in range(6):
        mse = numpy.mean((got[i].astype(numpy.float64) - expected[i]) ** 2)
        assert mse == 0.0 or 10.0 * numpy.log10(255.0 ** 2 / mse) >= 60.0


def test_stream_roundtrip_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    (params_np, bin_widths) = load_params_artifact(LEARNED)
    with pytest.raises(RuntimeError, match="cuda"):
        stream_roundtrip(params_from_jax(params_np), bin_widths,
                         synthetic_luminance_stack(2, 32, 32, seed=3), batch_size=2)


@pytest.mark.cuda
def test_batcher_concurrent_producers_share_one_stream_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA streams are per thread only there")
    stream = torch.cuda.Stream()
    seen = set()

    def batch_fn(batch):
        seen.add(torch.cuda.current_stream().cuda_stream)
        return batch.cuda() * 3.0

    batcher = ContinuousBatcher(batch_fn, batch_size=4, max_in_flight=2, stream=stream)

    def producer(base):
        for i in range(base, base + 25):
            batcher.submit(i, numpy.full((2,), float(i), numpy.float32))

    threads = [threading.Thread(target=producer, args=(k * 25,)) for k in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive()
    results = batcher.flush()
    assert seen == {stream.cuda_stream}
    for i in range(100):
        numpy.testing.assert_allclose(results[i], 3.0 * i)
