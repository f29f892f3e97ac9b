"""The share of the profiled job in which no operation ran on the card:
one less the union of the device's operation intervals inside the job,
over the job's length, in percent."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "depth_maps_per_s"


def read(ctx):
    job = ctx.profiled
    if job is None or job.device is None or job.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - job.device["busy_s"] / job.device["window_s"])
