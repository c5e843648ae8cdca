"""Reading a trace: interval unions, idle gaps named by the host's
activity, and the readers that return nothing where a run has nothing."""

import pytest

from codec_bench import harness, trace
from codec_bench.tests import helpers

DEVICE = [("gdn_f32_kernel<8>", 10.0, 20.0), ("sm80_xmma_fprop_implicit_gemm", 15.0, 30.0),
          ("sm80_xmma_fprop_implicit_gemm", 25.0, 35.0), ("elementwise_kernel", 60.0, 70.0),
          ("codec_bench.window", 0.0, 100.0)]
HOST = [(trace.WINDOW_SPAN, 0.0, 100.0), ("codec_bench.coder", 36.0, 58.0),
        ("aten::copy_", 40.0, 45.0), ("cudaLaunchKernel", 58.0, 60.0)]


@pytest.fixture
def traced():
    return trace.Trace([event for event in DEVICE if not event[0].startswith("codec_bench.")],
                       HOST)


def test_unions_and_window(traced):
    assert traced.window_s() == pytest.approx(100e-6)
    assert traced.busy_s() == pytest.approx(35e-6)
    assert traced.union(trace.is_conv) == pytest.approx(20e-6)
    assert traced.union(trace.is_gdn) == pytest.approx(10e-6)
    assert trace.union_s([(0.0, 5.0), (1.0, 2.0), (10.0, 12.0)], window=(1.0, 11.0)) == (
        pytest.approx(5e-6))


def test_gaps_named_by_the_host(traced):
    assert traced.gaps() == [(0.0, 10.0), (35.0, 60.0), (70.0, 100.0)]
    assert traced.host_activity(35.0, 60.0) == "codec_bench.coder"
    breakdown = traced.breakdown()
    assert breakdown["device_ops"][0] == ["sm80_xmma_fprop_implicit_gemm", pytest.approx(25e-6)]
    names = dict((name, seconds) for (name, seconds) in breakdown["idle_gaps"])
    assert names["codec_bench.coder"] == pytest.approx(25e-6)


def test_readers_find_nothing_in_a_run_without_a_trace(tmp_path):
    registry = helpers.checkout(str(tmp_path))
    for metric in registry.benchmark["per_layer"]:
        reader = registry.reader(metric["name"])
        assert reader.read(harness.Run()) is None


def test_readers_of_a_traced_run(traced, tmp_path):
    registry = helpers.checkout(str(tmp_path))
    run = harness.Run(window_s=2.0, work={"mpix": 1.0, "flops": {"fp32": 67e12}},
                      trace=traced, traced={"mpix": 2.0, "gdn_bound_s": 5e-6})
    values = {metric["name"]: registry.reader(metric["name"]).read(run)
              for metric in registry.benchmark["per_layer"]}
    assert values["conv_ms_per_mpix.train"] == pytest.approx(1e3 * 20e-6 / 2.0)
    assert values["gdn_roofline.train"] == pytest.approx(50.0)
    assert values["device_idle.train"] == pytest.approx(65.0)
    assert values["mfu.train"] == pytest.approx(50.0)
    assert values["conv_ms_per_mpix.serve"] == values["conv_ms_per_mpix.train"]
    assert values["coder_share.serve"] is None and values["request_p95_ms"] is None


def test_a_label_that_recorded_nothing_fails_loudly(traced):
    traced.require(["codec_bench.coder"])
    with pytest.raises(RuntimeError, match="codec_bench.fetch_wait"):
        traced.require(["codec_bench.coder", "codec_bench.fetch_wait"])


def test_split_metrics_share_their_base_reader():
    registry = harness.Registry()
    assert registry.reader("mfu.serve").read is not None
    assert registry.reader("mfu.serve").__file__ == registry.reader("mfu.train").__file__
    assert registry.reader("coder_share.serve").__file__.endswith("coder_share.serve.py")
