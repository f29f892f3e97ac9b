"""Seconds per depth map the card idles in the profiled job while SGM's
host steps run: the job's idle seconds whose innermost span is a program
step ``sgm.*``, ``graphs.capture``, or the bare estimation pass
(``photometric pass*``), over its maps. None without a trace, or where
the program keeps no recording or has no ``sgm.*`` span."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "device (H100)"
MOVES = "depth_maps_per_s"
PREFIXES = ("sgm.", "graphs.capture", "photometric pass")

install = program_trace.install


def _spanned(jobs, *names):
    """Every job kept a recording, and one of them a span of ``names``."""
    return program_trace.recorded(jobs) and any(
        sp.name in names for j in jobs for sp in j.recording.spans)


def read(ctx):
    job = ctx.profiled
    if job is None or job.device is None or not job.n_maps:
        return None
    if not _spanned([job], "sgm.view"):
        return None
    idle = job.device["idle_by_span"]
    return sum(s for name, s in idle.items() if name.startswith(PREFIXES)) / job.n_maps
