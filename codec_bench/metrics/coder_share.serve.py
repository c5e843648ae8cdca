"""Share of the served requests' wall time spent in the host coder:
the pipeline's own ``last_timing`` after each request, summed over the
window (``parallel/inference.py``, ``coding/``)."""


def read(run):
    if not run.requests:
        return None
    wall = sum(timing["wall"] for timing in run.requests)
    return 100.0 * sum(timing["coder"] for timing in run.requests) / wall if wall > 0 else None
