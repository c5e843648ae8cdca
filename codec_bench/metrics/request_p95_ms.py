"""The 95th percentile of the window's request latencies, from the call
until the reconstructions and bit counts are on the host."""


def read(run):
    return run.metrics.get("request_p95_ms")
