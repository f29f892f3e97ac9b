"""Host seconds of SGM's steps around the card per rectified pair: the self
seconds (less their children's) of the program's spans ``sgm.rectify``,
``sgm.inputs`` (resizes, range maps, copies to the card), ``sgm.check``
(cross-check, speckle filter, sub-pixel), ``sgm.project`` and ``sgm.fuse``
over the window's timed jobs, over the pairs matched (counter
``sgm.pairs``). None where the program keeps no recording or has no such
span."""

from mvs_bench import program_trace

UNIT = "s/pair"
LAYER = "SGM host steps"
MOVES = "depth_maps_per_s"
STEPS = ("sgm.rectify", "sgm.inputs", "sgm.check", "sgm.project", "sgm.fuse")

install = program_trace.install


def _spanned(jobs, *names):
    """Every job kept a recording, and one of them a span of ``names``."""
    return program_trace.recorded(jobs) and any(
        sp.name in names for j in jobs for sp in j.recording.spans)


def read(ctx):
    if not _spanned(ctx.jobs, *STEPS):
        return None
    pairs = sum(j.recording.counters.get("sgm.pairs", 0) for j in ctx.jobs)
    if not pairs:
        return None
    return sum(j.recording.self_s(name) for j in ctx.jobs for name in STEPS) / pairs
