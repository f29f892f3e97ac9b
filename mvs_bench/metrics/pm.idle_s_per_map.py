"""Seconds per depth map the card idles in the profiled job while
PatchMatch's host steps run: the job's idle seconds whose innermost span
is a program step ``pm.*``, ``graphs.capture``, or a bare estimation pass
(``photometric pass*``, ``geometric pass*``), over its maps. None without
a trace or where the program keeps no recording."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "device (H100)"
MOVES = "depth_maps_per_s"
PREFIXES = ("pm.", "graphs.capture", "photometric pass", "geometric pass")

install = program_trace.install


def read(ctx):
    job = ctx.profiled
    if job is None or job.device is None or not job.n_maps:
        return None
    if not program_trace.recorded([job]):
        return None
    idle = job.device["idle_by_span"]
    return sum(s for name, s in idle.items() if name.startswith(PREFIXES)) / job.n_maps
