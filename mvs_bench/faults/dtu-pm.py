"""The faults that the cells of ``dtu-pm`` can have, each planted in the
timed path through a test's ``monkeypatch``: a step that returns its state
unchanged, half of the views left out, and an answer altered where it is
produced. One card: no exchange between chips to leave out. Imports the
program only when a fault is planted."""

import numpy as np


def _state_unchanged(monkeypatch):
    from openmvs_tpu_torch.ops import graphs

    # every PatchMatch sweep hands back the state it was given
    monkeypatch.setattr(graphs.Sweeps, "sweep", lambda self, *a, **kw: None)
    monkeypatch.setattr(graphs.Sweeps, "block", lambda self, *a, **kw: None)


def _half_left_out(monkeypatch):
    from openmvs_tpu_torch import densify

    views = densify._run_views_parallel
    monkeypatch.setattr(densify, "_run_views_parallel",
                        lambda fn, idx, devices: views(fn, list(idx)[::2], devices))


def _answer_altered(monkeypatch):
    from openmvs_tpu_torch import densify

    opt = densify.optimize_depth_map

    def altered(res, opts):
        opt(res, opts)
        res.depth *= np.float32(1.02)

    monkeypatch.setattr(densify, "optimize_depth_map", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
