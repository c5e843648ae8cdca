"""Share of the served requests' wall time the pipeline waited for a
device-to-host copy (its symbols or reconstructions): ``last_timing``
after each request, summed over the window (``parallel/inference.py``)."""


def read(run):
    if not run.requests:
        return None
    wall = sum(timing["wall"] for timing in run.requests)
    return (100.0 * sum(timing["fetch_wait"] for timing in run.requests) / wall
            if wall > 0 else None)
