"""Seconds of a rectified pair's matching levels: the program's spans
``sgm.level`` (a level's inputs, its device program and download, and the
host's cross-check, speckle filter and sub-pixel fit) over the window's
timed jobs, over the pairs matched (counter ``sgm.pairs``). None where the
program keeps no recording or has no such span."""

from mvs_bench import program_trace

UNIT = "s/pair"
LAYER = "SGM levels"
MOVES = "depth_maps_per_s"

install = program_trace.install


def _spanned(jobs, *names):
    """Every job kept a recording, and one of them a span of ``names``."""
    return program_trace.recorded(jobs) and any(
        sp.name in names for j in jobs for sp in j.recording.spans)


def read(ctx):
    if not _spanned(ctx.jobs, "sgm.level"):
        return None
    pairs = sum(j.recording.counters.get("sgm.pairs", 0) for j in ctx.jobs)
    if not pairs:
        return None
    return sum(program_trace.seconds(j, "sgm.level") for j in ctx.jobs) / pairs
