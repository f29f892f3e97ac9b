"""Seconds a job spends capturing its sweep programs as CUDA graphs:
``graphs.Runner.capture_s`` summed over the runners of the job's
``dense_reconstruction`` call, averaged over the window's jobs. None where
nothing was captured (the CPU)."""

UNIT = "s"
LAYER = "sweep programs"
MOVES = "depth_maps_per_s"


def read(ctx):
    if not ctx.jobs or not any(j.captures for j in ctx.jobs):
        return None
    return sum(j.capture_s for j in ctx.jobs) / len(ctx.jobs)
