"""Share of the traced steps' device wall time (each step's ``step`` mark
to its ``step_end`` mark, ``codec_bench.phases``) in which no device
operation other than a mark ran: the launch gaps inside the replays."""

from codec_bench.phases import gap_seconds


def read(run):
    if run.trace is None:
        return None
    (gaps, walls) = gap_seconds(run.trace)
    return 100.0 * gaps / walls if walls > 0 else None
