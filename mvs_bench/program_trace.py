"""The program's own spans and counters, for the per-layer readers that
read them.

The port keeps spans and counters inside ``utils/log.recording()``: named
steps of ``dense_reconstruction`` (``pm.setup``, ``pm.download``,
``filter.project``, ``fuse.neighbours``, ...) and counters such as
``pm.sweeps``. ``install(probes)`` runs each ``dense_reconstruction`` call
of the run inside a recording and, at the call's end, keeps the recording
on the job (``job.recording``) and adds its dotted spans to ``job.spans``,
so that ``run.py`` gives their names to the device summary as labels and
idle time is named by the program step around it. The stage spans the
harness records (``photometric pass``, ``cross-view filter``, ...) have no
dot, so the existing readers' sums stay as they were.

A program without ``log.recording`` (older commits) is left alone: its
jobs keep no recording, and the readers of this module's numbers return
None. Imports nothing of the port until ``install`` runs.
"""

from __future__ import annotations


def dotted(name: str) -> bool:
    """A program step's span (``pm.setup``), not a stage's
    (``photometric pass (9 views)``)."""
    return "." in name and " " not in name


def install(probes) -> None:
    """Wrap ``densify.dense_reconstruction`` in ``log.recording()``, once
    per ``probes``."""
    if getattr(probes, "program_trace", False):
        return
    probes.program_trace = True
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.utils import log

    if not hasattr(log, "recording"):
        return
    call = densify.dense_reconstruction

    def recorded(*args, **kwargs):
        job = probes.job
        with log.recording() as rec:
            try:
                return call(*args, **kwargs)
            finally:
                if job is not None:
                    job.recording = rec
                    job.spans.extend((sp.name, sp.start_ns / 1e9, sp.end_ns / 1e9)
                                     for sp in rec.spans if dotted(sp.name))

    probes.patch(densify, "dense_reconstruction", recorded)


def recorded(jobs) -> bool:
    """Whether every job of ``jobs`` (at least one) kept a recording."""
    return bool(jobs) and all(getattr(j, "recording", None) is not None for j in jobs)


def seconds(job, *names: str) -> float:
    """The seconds of ``job``'s spans named exactly one of ``names``."""
    return sum(t1 - t0 for name, t0, t1 in job.spans if name in names)


def per_map(ctx, *names: str):
    """The spans ``names`` summed over the window's timed jobs, over their
    maps; None without a recording or a map."""
    if not ctx.maps or not recorded(ctx.jobs):
        return None
    return sum(seconds(j, *names) for j in ctx.jobs) / ctx.maps
